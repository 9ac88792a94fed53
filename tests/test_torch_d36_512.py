"""VAR-d36-s at 512px (``benchmark/configs/var-d36-512.json``) on the CPU:
the configuration loads into the port's modules at its published widths
(meta tensors, nothing allocated), and a tiny model of the same
architecture -- shared AdaLN, the q/k L2 norm, the whole 512 pyramid (L
2240), a VQVAE rendering 512 x 512 -- follows the benchmark's plain
reference (``benchmark/reference/models.py``) through the teacher-forced
logits, the eager CFG decode and the render. Logits are compared, not
tokens: two float32 programs that sum in another order may pick another
token where two logits tie to rounding, and the gap by which a served
token's reference logit lies below the best is what the benchmark's check
reads too."""

import json
import math
from pathlib import Path

import pytest
import torch

from benchmark.harness import sample, weights
from benchmark.reference import models as M
from var_tpu_torch import models as port_models
from var_tpu_torch.engine import sampler as tsm
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod

torch.set_num_threads(4)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = ROOT / "benchmark" / "configs" / "var-d36-512.json"
PN_512 = (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)
# float32 on both sides, sums in other orders: the widths' rounding is
# ~1e-6 relative; 1e-4 leaves room for the 2240-key softmax and 10 scales
# of residual updates without hiding a wrong operation (a dropped AdaLN
# term or a wrong stage moves the logits by O(0.1) at these scales).
TOL = dict(rtol=1e-4, atol=1e-4)


def _config() -> dict:
    return json.loads(CONFIG.read_text())


def test_the_config_is_the_published_d36_at_512px(monkeypatch):
    """The file's widths, pyramid and switches reach a ``VARConfig``
    through the harness's ``port_config`` and ``from_pretrained_dict``; the
    blocks hold ``ada_gss`` and no ``ada_lin``, the model one
    ``shared_ada_lin``; 2.354 B parameters, the same count on both sides."""
    cfg = _config()
    s = M.Sizes.from_config(cfg)
    assert (s.depth, s.embed_dim, s.num_heads, s.patch_nums) == (36, 2304, 36, PN_512)
    assert s.shared_aln and s.attn_l2_norm and s.seq_len == 2240 and s.reso == 512
    sd = {n: torch.empty(shape, device="meta") for n, shape in weights.names_shapes(s)}
    monkeypatch.setattr(port_models, "resolve_device", lambda device: torch.device("meta"))
    vae_cfg, var_cfg, vae, var = port_models.from_pretrained_dict(
        sample.port_config(cfg), sd, device="cpu", dtype=torch.bfloat16)
    assert var_cfg.shared_aln and var_cfg.attn_l2_norm and var_cfg.head_dim == 64
    assert (var_cfg.depth, var_cfg.embed_dim, var_cfg.seq_len) == (36, 2304, 2240)
    assert vae_cfg.v_patch_nums == PN_512 and vae_cfg.z_channels == 32
    assert all(hasattr(b, "ada_gss") and not hasattr(b, "ada_lin") for b in var.blocks)
    assert tuple(var.shared_ada_lin[1].weight.shape) == (6 * 2304, 2304)
    n_port = sum(p.numel() for p in var.parameters())
    n_ref = sum(math.prod(sh) for _, sh in weights.names_shapes(s, vae=False))
    assert n_port == n_ref == 2_353_893_904
    assert vae is not None and vae.cfg.ch == 160


@pytest.fixture(scope="module")
def tiny():
    """The d36-512 file cut to depth 2, C 64, 2 heads, V 64, 10 classes and
    a ch 32 VQVAE; everything else (shared AdaLN, the norm, the pyramid, the
    VQVAE's levels) as published. Seeded weights at trained-like scales."""
    cfg = _config()
    cfg.update(depth=2, embed_dim=64, num_heads=2, vocab_size=64, num_classes=10)
    cfg["vae"] = dict(cfg["vae"], ch=32)
    s = M.Sizes.from_config(cfg)
    sd = weights.make(s, 2 ** 31 + 36, "cpu")
    vae_cfg, var_cfg, vae, var = port_models.from_pretrained_dict(sample.port_config(cfg), sd,
                                                                  device="cpu")
    ref_vae, ref_var = M.build(s, sd, "cpu")
    assert var_cfg.shared_aln and var_cfg.seq_len == 2240
    return s, vae, var, ref_vae, ref_var


def _tokens(s: M.Sizes, b: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, s.vocab_size, (b, s.seq_len), generator=g)


def test_teacher_forced_logits_follow_the_reference(tiny):
    s, vae, var, ref_vae, ref_var = tiny
    tokens = _tokens(s, 2, 0)
    labels = torch.tensor([3, 8])
    idx = list(tokens.split([pn * pn for pn in s.patch_nums], dim=1))
    x_in = q.idxBl_to_var_input(vae.quantize, vae.cfg, idx)
    with M.exact():
        _, ref_x = M.pyramid(ref_vae, tokens)
        torch.testing.assert_close(x_in, ref_x, **TOL)
        want = M.forward(ref_var, labels, ref_x)
        got = var_mod.var_forward(var, labels, x_in, dtype=torch.float32, attn_impl="xla")
    assert got.shape == (2, 2240, s.vocab_size)
    torch.testing.assert_close(got, want, **TOL)


def test_the_eager_greedy_decode_and_its_render_follow_the_reference(tiny):
    """The CFG decode at top-k 1 serves, at every position, a token whose
    guided reference logit is the best to within 1e-3 (the benchmark's own
    float32 check, ``benchmark/tests``, wants the same); the served images
    are the reference's render of the served tokens to 1e-4 (float32 on
    both sides, the 512^2 decoder's sums in another order)."""
    s, vae, var, ref_vae, ref_var = tiny
    labels = torch.tensor([1, 6])
    with torch.inference_mode():
        res = tsm.decode_cfg(var, vae, labels, torch.Generator().manual_seed(5), cfg_scale=1.5,
                             top_k=1, top_p=0.0, dtype=torch.float32)
    assert res.tokens.shape == (2, 2240) and res.image.shape == (2, 512, 512, 3)
    with M.exact(), torch.no_grad():
        ref = M.cfg_logits(ref_var, ref_vae, labels, res.tokens, 1.5)
        gap = ref.max(-1).values - ref.gather(-1, res.tokens[..., None])[..., 0]
        assert float(gap.max()) < 1e-3
        f_hat, _ = M.pyramid(ref_vae, res.tokens)
        torch.testing.assert_close(res.f_hat, f_hat, **TOL)
        torch.testing.assert_close(res.image, M.decode(ref_vae, f_hat), **TOL)
        img = vae_mod.fhat_to_img(vae, f_hat) * 0.5 + 0.5
        torch.testing.assert_close(img, M.decode(ref_vae, f_hat), **TOL)
