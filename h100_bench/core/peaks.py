"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its 700 W
limit: the roofline's and the mfu shares' denominators. fp32 is the rate
outside the tensor cores: the harness turns TF32 off, as the port runs."""
from __future__ import annotations

from typing import Mapping

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12,
                  "float32": 67e12}


def least_seconds(ops: Mapping[str, float], nbytes: float) -> float:
    """The least time of a piece of work: its operations at the peak of each
    one's dtype, or its bytes at the memory's peak, whichever is longer."""
    t_ops = sum(n / PEAK_OPS_PER_S[dt] for dt, n in ops.items())
    return max(t_ops, nbytes / PEAK_BYTES_PER_S)
