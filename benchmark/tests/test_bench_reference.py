"""The plain reference against the program's plain PyTorch path, on the CPU
at a tiny size: one dict of seeded weights loads into both, and the two
agree in float32. (The test may import both; the reference imports
nothing of the program.)"""

import pytest
import torch

from benchmark.harness import check, sample, train, weights
from benchmark.reference import models as M
from benchmark.tests.conftest import cpu_context


@pytest.fixture
def both(tiny_config):
    from var_tpu_torch.models import from_pretrained_dict

    s = M.Sizes.from_config(tiny_config)
    sd = weights.make(s, 123, "cpu")
    _, _, vae, var = from_pretrained_dict(sample.port_config(tiny_config), sd, device="cpu")
    ref_vae, ref_var = M.build(s, sd, "cpu")
    return s, vae, var, ref_vae, ref_var


def test_weights_repeat_from_the_seed(tiny_config):
    s = M.Sizes.from_config(tiny_config)
    a, b, c = weights.make(s, 5, "cpu"), weights.make(s, 5, "cpu"), weights.make(s, 6, "cpu")
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.weight"], c["head.weight"])


def test_teacher_forced_logits_match(both):
    from var_tpu_torch.models import quantizer as q
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod

    s, vae, var, ref_vae, ref_var = both
    g = torch.Generator().manual_seed(0)
    img = torch.rand(3, s.reso, s.reso, 3, generator=g) * 2 - 1
    labels = torch.tensor([1, 4, 9])
    idx = vae_mod.img_to_idxBl(vae, img)
    ref_idx = M.tokenize(ref_vae, M.encode(ref_vae, img))
    assert all(torch.equal(a, b) for a, b in zip(idx, ref_idx))
    x_in = q.idxBl_to_var_input(vae.quantize, vae.cfg, idx)
    f_hat, ref_x = M.pyramid(ref_vae, torch.cat(ref_idx, 1))
    torch.testing.assert_close(ref_x, x_in, rtol=1e-5, atol=1e-5)
    got = var_mod.var_forward(var, labels, x_in, dtype=torch.float32, attn_impl="xla")
    torch.testing.assert_close(M.forward(ref_var, labels, ref_x), got, rtol=1e-4, atol=1e-4)
    img_port = vae_mod.fhat_to_img(vae, f_hat) * 0.5 + 0.5
    torch.testing.assert_close(M.decode(ref_vae, f_hat), img_port, rtol=1e-4, atol=1e-4)


def test_served_decodes_read_no_gap(tiny_config, tiny_sample_traffic):
    out = sample.run(cpu_context(tiny_config, tiny_sample_traffic))
    assert out["checked"] == {"greedy": 1, "sampled": 1}
    for name, v in out["numbers"].items():
        assert v < 1e-3, (name, v)


def test_training_steps_follow_the_reference(tiny_config, tiny_train_traffic):
    out = train.run(cpu_context(tiny_config, tiny_train_traffic))
    for name, v in out["numbers"].items():
        assert v < 1e-4, (name, v)


def test_the_filter_keeps_top_k_then_top_p():
    logits = torch.tensor([[3.0, 2.0, 1.0, 0.0, -1.0]])
    p = torch.softmax(logits[0, :3], 0)  # top-p renormalises over the top-k
    assert check.kept(logits, 3, 0.0).tolist() == [[True, True, True, False, False]]
    # the third token is kept while the mass before it is under top_p
    assert check.kept(logits, 3, float(p[0] + p[1]) + 1e-4)[0, 2]
    assert not check.kept(logits, 3, float(p[0] + p[1]) - 1e-4)[0, 2]
    assert check.kept(logits, 3, 1e-6).tolist() == [[True, False, False, False, False]]
