"""Package hygiene of the port: it imports neither JAX nor the JAX package,
and its entry points run on the GPU unless the caller asks for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from var_tpu_torch.config import VAEConfig, VARConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import var_tpu_torch
names = [m.name for m in pkgutil.walk_packages(var_tpu_torch.__path__, 'var_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'var_tpu' or m.startswith('var_tpu.'))
assert not bad, bad
assert 'triton' not in sys.modules
print(len(names))
"""


def test_port_imports_no_jax_and_nothing_of_var_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module of the package was imported


def _no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")


def test_make_sampler_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.engine.sampler import make_sampler

    with pytest.raises(RuntimeError, match="cuda"):
        make_sampler(VARConfig(), VAEConfig())


def test_build_vae_var_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.models import build_vae_var

    with pytest.raises(RuntimeError, match="cuda"):
        build_vae_var(depth=2, patch_nums=(1, 2))


def test_sample_app_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.sample import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--depth", "2", "--pn", "1_2"])


def test_sample_app_runs_on_cpu_when_asked(tmp_path):
    from var_tpu_torch.apps.sample import main

    out = tmp_path / "demo.png"
    main(["--device", "cpu", "--depth", "2", "--pn", "1_2", "--classes", "1,2",
          "--out", str(out), "--vae_ckpt", str(tmp_path / "absent.pth")])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_sampler_refuses_modules_on_another_device():
    from var_tpu_torch.engine.sampler import make_sampler
    from var_tpu_torch.models import build_vae_var

    vae_cfg, var_cfg, vae, var = build_vae_var(device="cpu", depth=2, patch_nums=(1, 2),
                                               ch=32, V=64)
    sampler = make_sampler(var_cfg, vae_cfg, device="cpu")
    with pytest.raises(ValueError):
        sampler(var.to("meta"), vae, None, [1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_vae_var_stores_block_matmuls_in_compute_dtype(dtype):
    from var_tpu_torch.models import build_vae_var

    _, _, _, var = build_vae_var(device="cpu", depth=2, patch_nums=(1, 2), ch=32, V=64,
                                 dtype=dtype)
    blk = var.blocks[0]
    for t in (blk.attn.mat_qkv.weight, blk.attn.proj.weight, blk.attn.q_bias,
              blk.attn.v_bias, blk.ffn.fc1.weight, blk.ffn.fc2.bias):
        assert t.dtype == dtype
    # consumed in float32 whatever the compute dtype
    for t in (blk.ada_lin[1].weight, var.head.weight, var.word_embed.weight):
        assert t.dtype == torch.float32


def test_train_app_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--local_debug=1"])


def test_build_vae_var_train_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.models import build_vae_var_train

    with pytest.raises(RuntimeError, match="cuda"):
        build_vae_var_train(depth=2, patch_nums=(1, 2))


def test_profile_train_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.profile_train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--depth", "2"])


def test_train_app_without_local_debug_names_the_data_slice():
    from var_tpu_torch.apps.train import main

    with pytest.raises(NotImplementedError, match="data"):
        main(["--device", "cpu"])


def test_build_vae_var_train_keeps_fp32_trainable_params():
    from var_tpu_torch.models import build_vae_var_train

    _, _, vae, var = build_vae_var_train(device="cpu", depth=2, patch_nums=(1, 2), ch=32, V=64)
    assert var.training and not vae.training
    assert all(p.dtype == torch.float32 and p.requires_grad for p in var.parameters())
    assert not any(p.requires_grad for p in vae.parameters())
    assert hasattr(vae, "encoder") and hasattr(vae, "quant_conv")
