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
assert 'PIL' not in sys.modules  # images are read inside the functions that need them
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


# the training-attention kernels of rows 5 and 6 as the profiler
# (demangled) and cuobjdump (mangled) name them, with the kind profile_train
# groups them under; the fp32 path's delta kernel serves both rows
KERNEL_KINDS = [
    ("void ptrain_dq_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, "
     "__nv_bfloat16*, int, int, int, Ends)", "paired_train_bwd"),
    ("void ptrain_dkv_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, Ends)",
     "paired_train_bwd"),
    ("void ptrain_dq_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float*, "
     "__nv_bfloat16*, int, int, int, Ends)", "flash_attention_bwd"),
    ("void ptrain_dkv_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, __nv_bfloat16*, int, int, int, Ends)",
     "flash_attention_bwd"),
    ("void ptrain_dq_f32_kernel<5>(float const*, float const*, float const*, float const*, "
     "float const*, float const*, float*, int, int, int, Ends)", "flash_attention_bwd"),
    ("_Z22ptrain_dq_wgmma_kernelILi6EEv14CUtensorMap_stS0_S0_S0_PK13__nv_bfloat16S3_PKfPfPS1_iii4Ends",
     "paired_train_bwd"),
    ("_Z23ptrain_dkv_wgmma_kernelILi5EEv14CUtensorMap_stS0_S0_S0_PKfP13__nv_bfloat16S4_iii4Ends",
     "flash_attention_bwd"),
    ("void train_delta_f32_kernel(float const*, float const*, float*, int, int)", "other"),
    ("void ptrain_fwd_wgmma_kernel<5>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, float*, int, int, int, Ends)", "flash_attention_fwd"),
    ("void ptrain_fwd_wgmma_kernel<6>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16*, float*, int, int, int, Ends)", "paired_train_fwd"),
    ("_Z23ptrain_fwd_wgmma_kernelILi5EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16Pfiii4Ends",
     "flash_attention_fwd"),
]


@pytest.mark.parametrize("name,kind", KERNEL_KINDS)
def test_profile_train_kind_groups_the_training_attention_kernels(name, kind):
    """profile_train's ``_kind`` puts each backward kernel of rows 5 and 6
    (and their forwards) under its row, by the kRow template argument; the
    fp32 delta kernel, of neither row, under 'other'."""
    from var_tpu_torch.apps.profile_train import _kind

    assert _kind(name) == kind


DECODE_KERNEL_KINDS = [
    ("void (anonymous namespace)::topk_topp_bound_kernel<1024>(float const*, int*, int, int, "
     "float)", "topk_topp_bound"),
    ("void (anonymous namespace)::topk_topp_bound_kernel<256>(float const*, int*, int, int, "
     "float)", "topk_topp_bound"),
    ("_ZN41_GLOBAL__N__1190a843_9_select_cu_3d17efc422topk_topp_bound_kernelILi512EEEvPKfPiiif",
     "topk_topp_bound"),
    ("void (anonymous namespace)::modulated_ln_kernel<__nv_bfloat16, 4>(__nv_bfloat16 const*, "
     "float const*, float const*, __nv_bfloat16*, long long, int, int, long long, long long, "
     "float, bool)", "modulated_ln"),
    ("void (anonymous namespace)::modulated_ln_kernel<float, 18>(float const*, float const*, "
     "float const*, float*, long long, int, int, long long, long long, float, bool)",
     "modulated_ln"),
    ("_ZN44_GLOBAL__N__bf3534bb_11_fused_ln_cu_87a5bffb19modulated_ln_kernel"
     "I13__nv_bfloat16Li4EEEvPKT_PKfS6_PS2_xiixxfb", "modulated_ln"),
]


@pytest.mark.parametrize("name,kind", DECODE_KERNEL_KINDS)
def test_profile_decode_kind_groups_rows_1_and_3(name, kind):
    """profile_decode's ``_kind`` puts every instantiation of the row 1 and
    row 3 kernels under its row, by demangled and by mangled name."""
    from var_tpu_torch.apps.profile_decode import _kind

    assert _kind(name) == kind


def test_stage_kernels_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.stage_kernels import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--iters", "1"])


def test_build_vae_train_default_device_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.models import build_vae_train

    with pytest.raises(RuntimeError, match="cuda"):
        build_vae_train(cfg=VAEConfig(ch=32, ch_mult=(1, 1), v_patch_nums=(1, 2)))


def test_profile_vae_train_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.profile_vae_train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--batch", "1"])


def test_build_vae_train_keeps_fp32_trainable_params():
    from var_tpu_torch.models import build_vae_train

    vae = build_vae_train(device="cpu", cfg=VAEConfig(ch=32, ch_mult=(1, 1), vocab_size=64,
                                                      v_patch_nums=(1, 2)))
    assert vae.training
    assert all(p.dtype == torch.float32 and p.requires_grad for p in vae.parameters())
    assert hasattr(vae, "encoder") and hasattr(vae, "decoder")


def test_train_app_without_local_debug_names_the_data_slice(tmp_path, monkeypatch):
    """Without --local_debug the CLI trains on --data_path's folders and
    names the one it cannot read."""
    from var_tpu_torch.apps.train import main

    monkeypatch.setenv("VAR_TPU_VAE_CKPT", str(tmp_path / "absent.pth"))
    with pytest.raises(FileNotFoundError, match="absent_data"):
        main(["--device", "cpu", "--depth=2", "--pn=1_2_3", "--allow_random_vae=1",
              f"--data_path={tmp_path / 'absent_data'}",
              f"--local_out_dir_path={tmp_path / 'out'}"])


def test_build_vae_var_train_keeps_fp32_trainable_params():
    from var_tpu_torch.models import build_vae_var_train

    _, _, vae, var = build_vae_var_train(device="cpu", depth=2, patch_nums=(1, 2), ch=32, V=64)
    assert var.training and not vae.training
    assert all(p.dtype == torch.float32 and p.requires_grad for p in var.parameters())
    assert not any(p.requires_grad for p in vae.parameters())
    assert hasattr(vae, "encoder") and hasattr(vae, "quant_conv")


@pytest.mark.parametrize("app", ["inpaint", "smooth", "classify"])
def test_zeroshot_app_default_device_raises_without_gpu(app, tmp_path):
    _no_gpu()
    import importlib

    main = importlib.import_module(f"var_tpu_torch.apps.{app}").main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--depth", "2", "--pn", "1_2", "--data_path", str(tmp_path)])


def test_decode_host_cost_raises_without_gpu():
    _no_gpu()
    from var_tpu_torch.apps.decode_host_cost import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["--iters", "1"])


_IMPORT_PARALLEL = """
import sys
import torch.distributed as dist
import var_tpu_torch.parallel.mesh, var_tpu_torch.parallel.shard_attn
import var_tpu_torch.apps.dryrun_multigpu
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'var_tpu' or m.startswith('var_tpu.'))
assert not bad, bad
assert not dist.is_initialized()  # importing joins no process group
"""


def test_parallel_modules_import_no_jax_and_no_process_group():
    """The multi-GPU modules (``parallel/mesh.py``, ``parallel/shard_attn.py``
    and the dry run) import neither JAX nor the JAX package, and importing
    them starts no process group."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_PARALLEL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("app,argv", [
    ("fid_score", ["ref", "samples", "--extractor", "pixel"]),
    ("fid_sample", ["--depth", "2", "--pn", "1_2", "--V", "64", "--Cvae", "8", "--ch", "32"]),
    ("quality_loop", ["--vae_steps", "1"]),
    ("analysis", ["--depths", "2", "--pn", "1_2", "--data_path", "imgs"]),
    ("dryrun_multigpu", ["--n", "2"]),
])
def test_new_app_default_device_raises_without_gpu(app, argv, tmp_path, monkeypatch):
    """The FID, quality-loop, analysis and multi-GPU dry-run CLIs default to
    ``cuda`` and raise without a GPU before any work (nothing is written
    into the working directory); ``--device cpu`` is the only way to the
    CPU."""
    _no_gpu()
    import importlib

    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(f"var_tpu_torch.apps.{app}").main
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("factory", ["make_vae_extractor", "make_pixel_extractor"])
def test_fid_extractors_default_device_raises_without_gpu(factory):
    _no_gpu()
    from var_tpu_torch.metrics import fid

    with pytest.raises(RuntimeError, match="cuda"):
        getattr(fid, factory)()


def test_dryrun_multigpu_refuses_more_nccl_ranks_than_cards(monkeypatch):
    """On a one-card machine ``--n 2`` (nccl, the default on cuda) raises
    before starting a rank; it does not fall back to the CPU."""
    from var_tpu_torch.apps import dryrun_multigpu as dry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dry, "launch", lambda *a, **k: pytest.fail("a rank was started"))
    with pytest.raises(RuntimeError, match="1 GPU"):
        dry.main(["--n", "2"])
