// Native PLY loader: binary and ascii PLY parsing, and a threaded prefetch
// ring so that reading point clouds overlaps the training steps (the port's
// own copy of the JAX package's native/ply_loader.cpp, built with g++ by
// data/native_loader.py).
//
// C ABI (ctypes):
//   ply_load(path, max_pts, out_xyz[max_pts*3], out_rgb[max_pts*3]) -> n
//   loader_create(n_workers, max_pts, capacity) -> handle
//   loader_submit(handle, path, cam2base[16] or NULL)
//   loader_next(handle, out_xyz, out_rgb, out_valid) -> n  (blocking, FIFO)
//   loader_destroy(handle)
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Prop {
  char name[16];
  int size;    // bytes
  char kind;   // 'f' float, 'd' double, 'u' uint8, 'U' uint16, 'i' int32
};

int type_info(const char* t, Prop* p) {
  struct {
    const char* n;
    int size;
    char kind;
  } table[] = {{"float", 4, 'f'},  {"float32", 4, 'f'}, {"double", 8, 'd'},
               {"float64", 8, 'd'}, {"uchar", 1, 'u'},  {"uint8", 1, 'u'},
               {"char", 1, 'u'},    {"int8", 1, 'u'},   {"ushort", 2, 'U'},
               {"uint16", 2, 'U'},  {"short", 2, 'U'},  {"int16", 2, 'U'},
               {"int", 4, 'i'},     {"int32", 4, 'i'},  {"uint", 4, 'i'},
               {"uint32", 4, 'i'}};
  for (auto& e : table) {
    if (strcmp(t, e.n) == 0) {
      p->size = e.size;
      p->kind = e.kind;
      return 0;
    }
  }
  return -1;
}

double read_prop(const uint8_t* ptr, const Prop& p) {
  switch (p.kind) {
    case 'f': {
      float v;
      memcpy(&v, ptr, 4);
      return v;
    }
    case 'd': {
      double v;
      memcpy(&v, ptr, 8);
      return v;
    }
    case 'u':
      return *ptr;
    case 'U': {
      uint16_t v;
      memcpy(&v, ptr, 2);
      return v;
    }
    case 'i': {
      int32_t v;
      memcpy(&v, ptr, 4);
      return v;
    }
  }
  return 0.0;
}

}  // namespace

extern "C" {

// Returns number of points read (<= max_pts), or -1 on error.
// out_rgb filled with values in [0, 1]; zeros when the file has no color.
long ply_load(const char* path, long max_pts, float* out_xyz, float* out_rgb) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(fsize);
  if (fread(buf.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return -1;
  }
  fclose(f);

  // ---- header
  const char* data = reinterpret_cast<const char*>(buf.data());
  const char* end_hdr = strstr(data, "end_header");
  if (!end_hdr) return -1;
  const char* body = strchr(end_hdr, '\n');
  if (!body) return -1;
  body++;

  bool binary = false, ascii = false;
  long n_vertex = 0;
  bool in_vertex = false;
  std::vector<Prop> props;
  std::string header(data, end_hdr - data);
  char line[256];
  const char* cur = header.c_str();
  while (*cur) {
    int i = 0;
    while (*cur && *cur != '\n' && i < 255) line[i++] = *cur++;
    line[i] = 0;
    if (*cur) cur++;
    char a[64], b[64], c[64];
    if (sscanf(line, "format %63s", a) == 1) {
      binary = strncmp(a, "binary_little", 13) == 0;
      ascii = strcmp(a, "ascii") == 0;
    } else if (sscanf(line, "element %63s %63s", a, b) == 2) {
      in_vertex = strcmp(a, "vertex") == 0;
      if (in_vertex) n_vertex = atol(b);
    } else if (in_vertex && sscanf(line, "property %63s %63s", a, c) == 2) {
      if (strcmp(a, "list") == 0) return -1;
      Prop p;
      if (type_info(a, &p) != 0) return -1;
      strncpy(p.name, c, 15);
      p.name[15] = 0;
      props.push_back(p);
    }
  }
  if (!binary && !ascii) return -1;

  int ix = -1, iy = -1, iz = -1, ir = -1, ig = -1, ib = -1;
  long stride = 0;
  for (size_t i = 0; i < props.size(); i++) {
    const char* nm = props[i].name;
    if (strcmp(nm, "x") == 0) ix = i;
    if (strcmp(nm, "y") == 0) iy = i;
    if (strcmp(nm, "z") == 0) iz = i;
    if (strcmp(nm, "red") == 0) ir = i;
    if (strcmp(nm, "green") == 0) ig = i;
    if (strcmp(nm, "blue") == 0) ib = i;
    stride += props[i].size;
  }
  if (ix < 0 || iy < 0 || iz < 0) return -1;
  bool has_rgb = ir >= 0 && ig >= 0 && ib >= 0;

  long n = n_vertex < max_pts ? n_vertex : max_pts;
  if (binary) {
    std::vector<long> offs(props.size());
    long off = 0;
    for (size_t i = 0; i < props.size(); i++) {
      offs[i] = off;
      off += props[i].size;
    }
    const uint8_t* p = reinterpret_cast<const uint8_t*>(body);
    const uint8_t* lim = buf.data() + fsize;
    for (long v = 0; v < n; v++, p += stride) {
      if (p + stride > lim) return v;
      out_xyz[v * 3 + 0] = (float)read_prop(p + offs[ix], props[ix]);
      out_xyz[v * 3 + 1] = (float)read_prop(p + offs[iy], props[iy]);
      out_xyz[v * 3 + 2] = (float)read_prop(p + offs[iz], props[iz]);
      if (has_rgb) {
        double scale = props[ir].kind == 'u' ? (1.0 / 255.0)
                       : props[ir].kind == 'U' ? (1.0 / 65535.0)
                                               : 1.0;
        out_rgb[v * 3 + 0] = (float)(read_prop(p + offs[ir], props[ir]) * scale);
        out_rgb[v * 3 + 1] = (float)(read_prop(p + offs[ig], props[ig]) * scale);
        out_rgb[v * 3 + 2] = (float)(read_prop(p + offs[ib], props[ib]) * scale);
      } else {
        out_rgb[v * 3] = out_rgb[v * 3 + 1] = out_rgb[v * 3 + 2] = 0.f;
      }
    }
    return n;
  }

  // ascii
  const char* p = body;
  for (long v = 0; v < n; v++) {
    double vals[32];
    size_t np = props.size() < 32 ? props.size() : 32;
    for (size_t i = 0; i < np; i++) {
      char* endp;
      vals[i] = strtod(p, &endp);
      if (endp == p) return v;
      p = endp;
    }
    out_xyz[v * 3 + 0] = (float)vals[ix];
    out_xyz[v * 3 + 1] = (float)vals[iy];
    out_xyz[v * 3 + 2] = (float)vals[iz];
    if (has_rgb) {
      double scale = props[ir].kind == 'u' ? (1.0 / 255.0) : 1.0;
      out_rgb[v * 3 + 0] = (float)(vals[ir] * scale);
      out_rgb[v * 3 + 1] = (float)(vals[ig] * scale);
      out_rgb[v * 3 + 2] = (float)(vals[ib] * scale);
    } else {
      out_rgb[v * 3] = out_rgb[v * 3 + 1] = out_rgb[v * 3 + 2] = 0.f;
    }
  }
  return n;
}

// ------------------------------------------------------- prefetch ring

struct Job {
  std::string path;
  bool has_tf;
  double tf[16];
  long seq;
};

struct Result {
  std::vector<float> xyz, rgb;
  std::vector<uint8_t> valid;
  long n;
  long seq;
};

struct Loader {
  long max_pts;
  size_t capacity;
  std::deque<Job> jobs;
  std::deque<Result> results;
  long next_submit = 0;
  long next_emit = 0;
  std::mutex mu;
  std::condition_variable cv_job, cv_res;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void work() {
    std::vector<float> xyz(max_pts * 3), rgb(max_pts * 3);
    while (true) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return stop.load() || !jobs.empty(); });
        if (stop.load() && jobs.empty()) return;
        job = jobs.front();
        jobs.pop_front();
      }
      long n = ply_load(job.path.c_str(), max_pts, xyz.data(), rgb.data());
      if (n < 0) n = 0;
      Result res;
      res.n = n;
      res.seq = job.seq;
      res.xyz.assign(max_pts * 3, 0.f);
      res.rgb.assign(max_pts * 3, 0.f);
      res.valid.assign(max_pts, 0);
      for (long i = 0; i < n; i++) {
        float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
        // range filter (||p|| < 3 m, as data/replay.load_rgb_pcd)
        if (x * x + y * y + z * z >= 9.0f) continue;
        float ox = x, oy = y, oz = z;
        if (job.has_tf) {
          const double* t = job.tf;
          ox = (float)(t[0] * x + t[1] * y + t[2] * z + t[3]);
          oy = (float)(t[4] * x + t[5] * y + t[6] * z + t[7]);
          oz = (float)(t[8] * x + t[9] * y + t[10] * z + t[11]);
        }
        res.xyz[i * 3] = ox;
        res.xyz[i * 3 + 1] = oy;
        res.xyz[i * 3 + 2] = oz;
        // rgb normalization: (rgb - 0.5) / 0.5
        res.rgb[i * 3] = rgb[i * 3] * 2.f - 1.f;
        res.rgb[i * 3 + 1] = rgb[i * 3 + 1] * 2.f - 1.f;
        res.rgb[i * 3 + 2] = rgb[i * 3 + 2] * 2.f - 1.f;
        res.valid[i] = 1;
      }
      {
        // a result enters inside the FIFO window [next_emit, next_emit +
        // capacity): at most `capacity` wait, and the next one to emit is
        // always let in, so loader_next never waits on a worker that waits
        // for room held by later results
        std::unique_lock<std::mutex> lk(mu);
        cv_res.wait(lk, [&] {
          return stop.load() || res.seq < next_emit + (long)capacity;
        });
        if (stop.load()) return;
        results.push_back(std::move(res));
      }
      cv_res.notify_all();
    }
  }
};

void* loader_create(int n_workers, long max_pts, long capacity) {
  Loader* L = new Loader();
  L->max_pts = max_pts;
  L->capacity = (size_t)(capacity < 1 ? 1 : capacity);
  for (int i = 0; i < n_workers; i++)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

void loader_submit(void* handle, const char* path, const double* cam2base) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  Job j;
  j.path = path;
  j.has_tf = cam2base != nullptr;
  if (j.has_tf) memcpy(j.tf, cam2base, sizeof(double) * 16);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    j.seq = L->next_submit++;
    L->jobs.push_back(std::move(j));
  }
  L->cv_job.notify_one();
}

// FIFO-ordered blocking pop; returns valid point count.
long loader_next(void* handle, float* out_xyz, float* out_rgb,
                 uint8_t* out_valid) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  Result res;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_res.wait(lk, [&] {
      for (auto& r : L->results)
        if (r.seq == L->next_emit) return true;
      return false;
    });
    for (auto it = L->results.begin(); it != L->results.end(); ++it) {
      if (it->seq == L->next_emit) {
        res = std::move(*it);
        L->results.erase(it);
        break;
      }
    }
    L->next_emit++;
  }
  L->cv_res.notify_all();
  memcpy(out_xyz, res.xyz.data(), sizeof(float) * L->max_pts * 3);
  memcpy(out_rgb, res.rgb.data(), sizeof(float) * L->max_pts * 3);
  memcpy(out_valid, res.valid.data(), L->max_pts);
  long n = 0;
  for (long i = 0; i < L->max_pts; i++) n += res.valid[i];
  return n;
}

void loader_destroy(void* handle) {
  Loader* L = reinterpret_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_job.notify_all();
  L->cv_res.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
