"""The plain training attention's softmax statistics on the CPU (rows 5 and
6's plain versions, ``ops/cuda/flash_attention.py``): taken in float64, so
that the CPU path, the oracle of every teacher-forced test, gives the same
bits in every process and at every intra-op thread count. With float32
statistics ``torch.logsumexp`` gave another value for one thread's rows in
some processes."""

import numpy as np
import pytest
import torch

from var_tpu_torch.ops.attention import block_causal_logits
from var_tpu_torch.ops.cuda import flash_attention as tfa

ENDS6 = (1, 5, 14, 30, 55, 91)
CASES = {"block_causal": ENDS6, "unmasked": None}


def _inputs(dtype=torch.float32):
    """Merged (B, L, C) q, k, v and do at the block-causal case of
    ``test_torch_long.py`` (B 2, L 91, 2 heads of 16)."""
    rng = np.random.default_rng(182)
    return [torch.from_numpy(rng.standard_normal((2, 91, 32)).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _with_threads(n, fn):
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_lse_is_float64_statistics_cast_to_float32(case):
    """lse equals the float64 logsumexp of the float32 logits, cast to
    float32, and out is p = exp(s - lse) (float64 from that float32 lse,
    rounded to the input dtype) times v."""
    ends = CASES[case]
    q, k, v, _ = _inputs()
    out, lse = tfa.paired_train_fwd_plain(q, k, v, 2, ends)
    logits = block_causal_logits(q.reshape(2, 91, 2, 16), k.reshape(2, 91, 2, 16), 1.0,
                                 ends).double()
    want_lse = torch.logsumexp(logits, dim=-1).float()
    assert lse.dtype == torch.float32 and torch.equal(lse, want_lse)
    p = torch.exp(logits - want_lse.double()[..., None]).float()
    want_out = torch.einsum("bhlm,bmhd->blhd", p, v.reshape(2, 91, 2, 16)).reshape(out.shape)
    assert torch.equal(out, want_out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_and_backward_repeat_at_every_thread_count(case, dtype):
    """The plain forward's out and lse, and the backward's dq, dk, dv, are
    the same bits with one intra-op thread, with the current count and
    with one a core."""
    ends = CASES[case]
    q, k, v, do = _inputs(getattr(torch, dtype))

    def run():
        out, lse = tfa.paired_train_fwd_plain(q, k, v, 2, ends)
        delta = tfa.paired_train_delta(out, do, 2)
        return (out, lse, *tfa.paired_train_bwd_plain(q, k, v, do, lse, delta, 2, ends))

    counts = sorted({1, torch.get_num_threads(), max(2, torch.get_num_threads() * 2)})
    runs = [_with_threads(n, run) for n in counts]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)
