"""The port's CLIP tokenizer and text tower against the JAX package's.

Tokenizer: ids equal, on merges written here (the standard merges file is
not in the repo), over instructions with non-ASCII letters and digits; the
word pattern (stdlib `re` with classes built from `unicodedata`) splits
every assigned Basic Multilingual Plane code point as the `regex` pattern
does, U+0345 aside (see models/clip_bpe.py). Text tower: 2 layers of width
64 with 4 heads, weights converted from the flax tree
(`convert.clip_text_to_state_dict`), fp32 within 1e-5 of each output's
largest |value|; and `data.kitchen.encode_task_instructions` with the full
12-layer tower on JAX's random weights, within the same bound of JAX's.
"""
import sys
import unicodedata

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_robot_nerf_actor_tpu.models import clip_bpe as jbpe
from real_robot_nerf_actor_tpu.models import clip_text as jct
from real_robot_nerf_actor_tpu_torch.convert import clip_text_to_state_dict
from real_robot_nerf_actor_tpu_torch.models import clip_bpe, clip_text

MERGES = [
    ("t", "h"), ("th", "e</w>"), ("e", "r</w>"), ("o", "n</w>"), ("a", "n"),
    ("an", "d</w>"), ("i", "n"), ("in", "g</w>"), ("o", "p"), ("op", "e"),
    ("ope", "n</w>"), ("d", "r"), ("a", "w"), ("dr", "aw"), ("draw", "er</w>"),
    ("g", "r"), ("gr", "a"), ("s", "p</w>"), ("gra", "sp</w>"), ("b", "o"),
    ("x", "</w>"), ("bo", "x</w>"), ("r", "e"), ("re", "d</w>"), ("é", "l"),
    ("él", "an</w>"), ("c", "a"), ("ca", "f"), ("caf", "é</w>"), ("l", "i"),
    ("li", "f"), ("lif", "t</w>"), ("u", "p</w>"), ("p", "r"), ("pr", "e"),
    ("pre", "s"), ("pres", "s</w>"), ("2", "</w>"),
]
INSTRUCTIONS = [
    "grasp the red box and lift it up",
    "press down on the blue box and return home",
    "Öffne die Schublade, café élan!",
    "put 3 cups² on shelf Ⅻ; ١٢ items",
    "δράσε τώρα: ξεκίνα 42 φορές",
    "打开抽屉 then   close\tthe drawer ",
    "it's the robot's 2nd try--we'll see",
    "ﬁne ligature ＡＢＣ full-width",
]


def _byte_merges():
    """MERGES with each character put through the byte-level unit map, as
    the merges file holds them (é is two bytes, so two units)."""
    b2u = jbpe.byte_to_unicode()

    def units(s):
        tail = s.endswith("</w>")
        core = s[:-4] if tail else s
        return "".join(b2u[b] for b in core.encode("utf-8")) + ("</w>" if tail else "")

    return [(units(a), units(b)) for a, b in MERGES]


def test_tokenizer_ids_match_jax():
    merges = _byte_merges()
    ours, theirs = clip_bpe.ClipBPETokenizer(merges), jbpe.ClipBPETokenizer(merges)
    assert ours.vocab_size == theirs.vocab_size and ours.eot_id == theirs.eot_id
    for text in INSTRUCTIONS:
        assert ours.encode(text) == theirs.encode(text), text
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))
    np.testing.assert_array_equal(ours.tokenize(INSTRUCTIONS), theirs.tokenize(INSTRUCTIONS))
    long = " ".join(["grasp"] * 100)
    np.testing.assert_array_equal(ours.tokenize(long, 16), theirs.tokenize(long, 16))
    with pytest.raises(ValueError):
        ours.tokenize(long, 16, truncate=False)


def test_tokenizer_from_file_matches_jax(tmp_path):
    path = tmp_path / "merges.txt.gz"
    import gzip
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in _byte_merges()) + "\n")
    got = clip_text.tokenize(INSTRUCTIONS, bpe_path=str(path))
    want = jct.tokenize(INSTRUCTIONS, bpe_path=str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(clip_text.tokenize(INSTRUCTIONS), jct.tokenize(INSTRUCTIONS))
    np.testing.assert_array_equal(clip_text.tokenize_simple("grasp it", 10, 500),
                                  jct.tokenize_simple("grasp it", 10, 500))


def test_word_pattern_splits_the_bmp_as_regex_does():
    chars = [chr(c) for c in range(0x10000)
             if not 0xD800 <= c <= 0xDFFF and c != 0x345
             and unicodedata.category(chr(c)) != "Cn"]
    assert len(chars) > 50000
    text = " ".join(chars) + " " + "".join(chars[::7]) + " a1b2²Ⅻ٣x"
    assert clip_bpe.word_pattern().findall(text) == jbpe._WORD_PATTERN.findall(text)
    assert clip_bpe._clean(text) == jbpe._clean(text)
    assert sys.maxunicode == 0x10FFFF


@pytest.fixture(scope="module")
def tiny_towers():
    cfg = dict(vocab_size=300, context_length=77, width=64, heads=4, layers=2, embed_dim=32)
    tokens = np.asarray(jct.tokenize(INSTRUCTIONS[:4]))
    tokens = np.where(tokens > 0, tokens % 298 + 1, 0)
    tokens[np.arange(4), np.argmax(jct.tokenize(INSTRUCTIONS[:4]), -1)] = 299   # EOT
    jenc = jct.ClipTextEncoder(jct.ClipTextConfig(**cfg))
    variables = jenc.init(jax.random.key(3), jnp.asarray(tokens))
    # random biases and LayerNorm affines too (flax starts them at 0 and 1)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim <= 2 and a.shape[0] != 300 else a, jax.device_get(variables))
    want = jenc.apply(variables, jnp.asarray(tokens))
    enc = clip_text.ClipTextEncoder(clip_text.ClipTextConfig(**cfg))
    enc.load_state_dict(clip_text_to_state_dict(variables))
    return enc, tokens, [np.asarray(w) for w in want], variables, cfg


def test_text_tower_matches_jax(tiny_towers):
    enc, tokens, want, _, _ = tiny_towers
    with torch.no_grad():
        got = enc(torch.as_tensor(tokens))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_open_clip_weights_convert_as_jax_does(tiny_towers):
    """An open CLIP state_dict through the port's converter equals it through
    JAX's converter and then clip_text_to_state_dict."""
    _, _, _, _, cfg = tiny_towers
    c = clip_text.ClipTextConfig(**cfg)
    w = c.width
    rng = np.random.default_rng(4)
    shapes = {"token_embedding.weight": (c.vocab_size, w),
              "positional_embedding": (c.context_length, w),
              "text_projection": (w, c.embed_dim), "ln_final.weight": (w,),
              "ln_final.bias": (w,)}
    for i in range(c.layers):
        t = f"transformer.resblocks.{i}."
        shapes.update({t + "attn.in_proj_weight": (3 * w, w), t + "attn.in_proj_bias": (3 * w,),
                       t + "attn.out_proj.weight": (w, w), t + "attn.out_proj.bias": (w,),
                       t + "ln_1.weight": (w,), t + "ln_1.bias": (w,),
                       t + "ln_2.weight": (w,), t + "ln_2.bias": (w,),
                       t + "mlp.c_fc.weight": (4 * w, w), t + "mlp.c_fc.bias": (4 * w,),
                       t + "mlp.c_proj.weight": (w, 4 * w), t + "mlp.c_proj.bias": (w,)})
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    got = clip_text.convert_torch_clip_text_weights(sd, c)
    want = clip_text_to_state_dict(jax.device_get(jct.convert_torch_clip_text_weights(
        sd, jct.ClipTextConfig(**cfg))))
    assert set(got) == set(want) == set(clip_text.ClipTextEncoder(c).state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_encode_task_instructions_matches_jax_on_its_weights():
    """The full 12-layer tower of width 512 on the random weights JAX's
    encode_task_instructions draws (jax.random.key(seed), initialised on the
    first instruction): the port's encode_task_instructions on the converted
    weights against the flax tower's per-token output. Without them the port
    draws other random weights, so lang_embs.npz differs between the
    packages (a deliberate difference)."""
    from real_robot_nerf_actor_tpu.data.synthetic import TASK_INSTRUCTIONS
    from real_robot_nerf_actor_tpu_torch.data.kitchen import encode_task_instructions
    tokens = jnp.asarray(jct.tokenize(list(TASK_INSTRUCTIONS)))
    tower = jct.ClipTextEncoder()
    variables = tower.init(jax.random.key(2), tokens[:1])
    want = np.asarray(tower.apply(variables, tokens)[1])
    got = encode_task_instructions(
        TASK_INSTRUCTIONS, seed=2, device="cpu",
        state_dict=clip_text_to_state_dict(jax.device_get(variables)))
    assert got.shape == want.shape == (3, 77, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    drawn = encode_task_instructions(TASK_INSTRUCTIONS, seed=2, device="cpu")
    assert drawn.shape == want.shape and np.abs(drawn - want).max() > 0.1
    np.testing.assert_array_equal(
        drawn, encode_task_instructions(TASK_INSTRUCTIONS, seed=2, device="cpu"))
