"""The port's data and tensor parallelism (``var_tpu_torch/parallel``) on the
CPU, against one process and against the JAX package's mesh.

One pair of gloo processes, joined through a file store under the test's
temporary directory (no port), runs every case of
``apps/dryrun_multigpu.py``'s tiny configuration (the JAX dry run's: depth
2, C 64, H 4, V 64, pn 1_2_3, ``attn_l2_norm``, global batch 4) at
(dp, mp) = (2, 1) and (1, 2): training steps with and without cond-drop
and drop-path, greedy CFG decodes, the planted ``copy_to_model`` fault and
the CLI's loop. Meanwhile this process runs JAX's ``make_train_step`` and
``decode_cfg`` with ``mesh=make_mesh(mp)`` over two of the 8 CPU devices
``tests/conftest.py`` gives JAX. Tolerances are the JAX dry run's
(``__graft_entry__.py:184-198``): loss within 1e-5 relative, parameters
max |diff| < 1e-5, greedy tokens equal; the gradient norm within 1e-5
relative and, against one process, each gradient within 1e-4 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from var_tpu.config import TrainArgs, VAEConfig, VARConfig
from var_tpu.engine import trainer as jtr
from var_tpu.engine.convert import convert_vae, convert_var
from var_tpu.engine.sampler import decode_cfg as jax_decode_cfg
from var_tpu.parallel import mesh as jpm
from var_tpu.parallel import shard_attn as jsa
from var_tpu_torch.apps import dryrun_multigpu as dry
from var_tpu_torch.data.imagenet import DistInfiniteBatchSampler
from var_tpu_torch.engine.convert import var_state_dict
from var_tpu_torch.models import var as tvar
from var_tpu_torch.parallel import mesh as pm
from var_tpu_torch.parallel import shard_attn as sa

torch.set_num_threads(2)

MESHES = ["2x1", "1x2"]
ADAM_B1 = 0.9  # make_adamw's (both packages)


def _jax_cfgs(spec):
    v, r = spec["vae"], spec["var"]
    return (VAEConfig(**dict(v, ch_mult=tuple(v["ch_mult"]),
                             v_patch_nums=tuple(v["v_patch_nums"]))),
            VARConfig(**dict(r, patch_nums=tuple(r["patch_nums"]))))


def _jax_runs(spec, vae, var):
    """JAX's mesh step (the ``plain`` case) and greedy decode for each mesh,
    from the port's seeded weights: {mesh: {loss, grad_norm, params, grads,
    tokens}}, with params and grads as reference-named state dicts. The
    step's gradients, clipped, are read back from AdamW's first moment,
    which after one step is (1 - b1) times them."""
    vae_cfg, var_cfg = _jax_cfgs(spec)
    vae_params = convert_vae({k: v.numpy() for k, v in vae.state_dict().items()}, vae_cfg)
    var_params = convert_var({k: v.numpy() for k, v in var.state_dict().items()}, var_cfg)
    args = TrainArgs(**dict(spec["args"], bs=spec["batch"], ac=1)).finalize(world_size=1)
    reso = var_cfg.patch_nums[-1] * vae_cfg.downsample
    imgs, labels = dry._batch(spec, 1, reso)
    dec_labels = jnp.asarray(np.arange(spec["batch"]) % var_cfg.num_classes, jnp.int32)
    d = spec["decode"]
    out = {}
    for dp, mp in spec["meshes"]:
        mesh = jpm.make_mesh(model_parallel=mp, devices=jax.devices()[:dp * mp])
        init_state, step = jtr.make_train_step(var_cfg, vae_cfg, args, iters_per_ep=4,
                                               dtype=jnp.float32, attn_impl="xla", mesh=mesh)
        with mesh:
            state = init_state(jax.tree.map(jnp.copy, var_params))
            state = jtr.TrainState(jpm.shard_var_params(mesh, state.params),
                                   jax.device_put(state.opt_state, jpm.replicated(mesh)),
                                   jax.device_put(state.step, jpm.replicated(mesh)))
            bsp = NamedSharding(mesh, P(None, jpm.DATA_AXIS))
            new, m = step(state, jax.device_put(vae_params, jpm.replicated(mesh)),
                          jax.device_put(imgs, bsp), jax.device_put(labels.astype(np.int32), bsp),
                          jax.random.PRNGKey(1), jnp.int32(0), jnp.float32(1.0))
            vp = (jpm.shard_var_params(mesh, var_params) if mp > 1
                  else jax.device_put(var_params, jpm.replicated(mesh)))
            res = jax.jit(lambda p, ve, lab: jax_decode_cfg(
                p, ve, var_cfg, vae_cfg, jax.random.PRNGKey(5), lab, cfg_scale=d["cfg_scale"],
                top_k=d["top_k"], dtype=jnp.float32, mesh=mesh))(
                vp, jax.device_put(vae_params, jpm.replicated(mesh)),
                jpm.shard_batch(mesh, dec_labels))
        params = var_state_dict(jax.tree.map(np.asarray, new.params), var_cfg)
        mu = var_state_dict(jax.tree.map(np.asarray, new.opt_state["adam"].mu), var_cfg)
        out[f"{dp}x{mp}"] = {"loss": float(m.loss), "grad_norm": float(m.grad_norm),
                             "params": params, "tokens": np.asarray(res.tokens),
                             "grads": {k: v.double() / (1 - ADAM_B1) for k, v in mu.items()}}
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(per-rank reports, rank 0's results, JAX's results) of one run."""
    spec = dict(dry.tiny_spec(2, "cpu", "gloo"), save=True)
    out = str(tmp_path_factory.mktemp("parallel"))
    run = dry.launch(spec, 2, out, timeout=300)
    try:
        vae, var = dry.build_models(spec, torch.device("cpu"))
        jax_out = _jax_runs(spec, vae, var)
    finally:
        reports, results = run.wait()
    return spec, sorted(reports, key=lambda r: r["rank"]), results, jax_out


# ---------------------------------------------------------------------------
# the mesh rules, no processes


@pytest.mark.parametrize("dp,mp", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4), (4, 2),
                                   (2, 4), (8, 1), (1, 8)])
def test_mesh_rules_match_jax(dp, mp):
    """axis_sizes, mesh_is_trivial, paired_mesh_ok and flash_mesh_ok give
    JAX's answers for every head count and batch of a grid."""
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:dp * mp]).reshape(dp, mp),
                              (jpm.DATA_AXIS, jpm.MODEL_AXIS))
    tmesh = pm.Mesh(dp=dp, mp=mp)
    assert sa.axis_sizes(tmesh) == jsa.axis_sizes(jmesh) == (dp, mp)
    assert sa.mesh_is_trivial(tmesh) == jsa.mesh_is_trivial(jmesh)
    for h in (1, 2, 3, 4, 6, 8, 16, 20):
        for b in (1, 2, 3, 4, 6, 8):
            assert sa.paired_mesh_ok(tmesh, h, b) == jsa.paired_mesh_ok(jmesh, h, b), (h, b)
            assert sa.flash_mesh_ok(tmesh, h, b) == jsa.flash_mesh_ok(jmesh, h, b), (h, b)
    assert sa.mesh_is_trivial(None) and not sa.paired_mesh_ok(None, 4, 4)
    assert not sa.flash_mesh_ok(None, 4, 4) and sa.axis_sizes(None) == (1, 1)


def test_trivial_mesh_creates_no_group_and_runs_no_collective():
    """Without a process group make_mesh() is the trivial mesh, with no
    groups, and every bridge and gather is the identity."""
    assert not torch.distributed.is_initialized()
    mesh = pm.make_mesh()
    assert (mesh.dp, mesh.mp, mesh.data_group, mesh.model_group) == (1, 1, None, None)
    x = torch.randn(2, 3, 4)
    for fn in (sa.copy_to_model, sa.reduce_from_model, sa.gather_from_model):
        assert fn(x, mesh) is x
    assert pm.gather_data(mesh, x) is x and pm.data_rows(mesh, 2) == (0, 2)
    assert not torch.distributed.is_initialized()


def _tiny_var(h=4, c=256):
    cfg = tvar.VARConfig(num_classes=10, depth=2, embed_dim=c, num_heads=h, patch_nums=(1, 2),
                         vocab_size=64, z_channels=8, attn_l2_norm=True)
    return tvar.init_var_params(tvar.VAR(cfg), torch.Generator().manual_seed(3))


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_then_gather_gives_back_the_state_dict_bit_for_bit(mp):
    var = _tiny_var()
    sd = var.state_dict()
    locals_ = [pm.shard_state_dict(sd, mp, r) for r in range(mp)]
    back = pm.unshard_state_dicts(locals_)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert sum(pm.is_sharded(k) for k in sd) == 2 * 8 + 2  # 8 tensors a block, the head's 2


@pytest.mark.parametrize("mp", [2, 4])
def test_qkv_shard_takes_each_segments_heads(mp):
    """Rank r's q, k and v rows are the heads r H/mp onward of each C-row
    block of the fused weight, its q_bias, v_bias and scale_mul the same
    heads; fc1 and the head split their rows, proj and fc2 their columns."""
    var = _tiny_var(h=8, c=512)
    c, h = 512, 8
    cl, hl = c // mp, h // mp
    sd = var.state_dict()
    for r in range(mp):
        loc = pm.shard_state_dict(sd, mp, r)
        w, wl = sd["blocks.1.attn.mat_qkv.weight"], loc["blocks.1.attn.mat_qkv.weight"]
        assert wl.shape == (3 * cl, c)
        for seg in range(3):
            assert torch.equal(wl[seg * cl:(seg + 1) * cl],
                               w[seg * c + r * cl:seg * c + (r + 1) * cl])
        for name in ("q_bias", "v_bias"):
            assert torch.equal(loc[f"blocks.1.attn.{name}"],
                               sd[f"blocks.1.attn.{name}"][r * cl:(r + 1) * cl])
        assert torch.equal(loc["blocks.1.attn.scale_mul_1H11"],
                           sd["blocks.1.attn.scale_mul_1H11"][:, r * hl:(r + 1) * hl])
        assert torch.equal(loc["blocks.1.attn.proj.weight"],
                           sd["blocks.1.attn.proj.weight"][:, r * cl:(r + 1) * cl])
        assert torch.equal(loc["blocks.1.attn.proj.bias"], sd["blocks.1.attn.proj.bias"])
        hid = 4 * c // mp
        assert torch.equal(loc["blocks.1.ffn.fc1.weight"],
                           sd["blocks.1.ffn.fc1.weight"][r * hid:(r + 1) * hid])
        assert torch.equal(loc["blocks.1.ffn.fc2.weight"],
                           sd["blocks.1.ffn.fc2.weight"][:, r * hid:(r + 1) * hid])
        assert torch.equal(loc["head.bias"], sd["head.bias"][r * 64 // mp:(r + 1) * 64 // mp])
        assert torch.equal(loc["head_nm.ada_lin.1.weight"], sd["head_nm.ada_lin.1.weight"])


def test_shard_var_params_holds_local_shapes_and_is_checked():
    var = _tiny_var()
    mesh = pm.Mesh(dp=1, mp=2, model_rank=1)
    assert pm.shard_var_params(pm.Mesh(), var) is var
    pm.shard_var_params(mesh, var)
    blk = var.blocks[0]
    assert blk.attn.mat_qkv.weight.shape == (384, 256) and blk.ffn.fc2.weight.shape == (256, 512)
    assert blk.attn.scale_mul_1H11.shape == (1, 2, 1, 1) and var.head.weight.shape == (32, 256)
    tvar.check_sharded(var, mesh)
    with pytest.raises(ValueError, match="shard_var_params"):
        tvar.check_sharded(var, None)


def test_approx_topk_gives_the_exact_decode():
    """approx_topk=True takes the exact path: the same sampled decode (same
    generator) as approx_topk=False, through make_sampler and decode_cfg,
    and the same draw from sample_with_top_k_top_p."""
    from var_tpu_torch.engine.sampler import decode_cfg, make_sampler
    from var_tpu_torch.models import build_vae_var
    from var_tpu_torch.ops.sampling import sample_with_top_k_top_p

    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 5, 64))).float()
    draws = [sample_with_top_k_top_p(logits, top_k=8, top_p=0.9, approx_topk=a,
                                     generator=torch.Generator().manual_seed(1))
             for a in (False, True)]
    assert torch.equal(draws[0], draws[1])

    vae_cfg, var_cfg, vae, var = build_vae_var(device="cpu", depth=2, patch_nums=(1, 2, 3),
                                               ch=32, V=64, dtype=torch.float32)
    labels = torch.tensor([1, 2])
    runs = [make_sampler(var_cfg, vae_cfg, top_k=8, top_p=0.9, dtype=torch.float32,
                         device="cpu", approx_topk=a)(var, vae, torch.Generator().manual_seed(0),
                                                      labels) for a in (False, True)]
    assert torch.equal(runs[0].tokens, runs[1].tokens)
    with torch.inference_mode():
        direct = decode_cfg(var, vae, labels, torch.Generator().manual_seed(0), top_k=8,
                            top_p=0.9, dtype=torch.float32, approx_topk=True)
    assert torch.equal(direct.tokens, runs[0].tokens)


@pytest.mark.parametrize("backend", [None, "nccl", "gloo"])
def test_initialize_distributed_refuses_more_ranks_than_cards(monkeypatch, backend):
    """A LOCAL_RANK beyond the cards present raises before joining, unless
    the caller names gloo (two ranks sharing one card); then the rank takes
    card LOCAL_RANK modulo the cards and joins with the named backend."""
    joined, cards = [], []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda b, **kw: joined.append((b, kw["rank"], kw["world_size"])))
    if backend == "gloo":
        pm.initialize_distributed(backend)
        assert cards == [0] and joined == [("gloo", 1, 2)]
    else:
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1 but 1 GPU"):
            pm.initialize_distributed(backend)
        assert cards == [] and joined == []


# ---------------------------------------------------------------------------
# the process pair


@pytest.mark.parametrize("case", ["train_drop", "train_plain", "decode_chunked"])
@pytest.mark.parametrize("mesh", MESHES)
def test_parallel_run_matches_one_process(pair, mesh, case):
    """Every rank's (dp, mp) step or greedy decode against its own
    one-process run: the drop case draws cond-drop and drop-path for the
    global batch (ac 2), so the masks are the one-process step's."""
    _, reports, _, _ = pair
    for rep in reports:
        c = rep["meshes"][mesh][case]
        assert c["ok"], (rep["rank"], c)
    if case.startswith("train"):
        assert reports[0]["meshes"][mesh][case]["heads_local"] == (2 if mesh == "1x2" else 4)


@pytest.mark.parametrize("mesh", MESHES)
def test_parallel_train_step_matches_jax_mesh_step(pair, mesh):
    """The port's (dp, mp) step (no cond-drop or drop-path: the frameworks'
    random streams differ) against JAX's make_train_step(mesh=make_mesh(mp))
    on the same weights and batch: loss, gradient norm, each tensor's
    clipped gradient within 1e-4 of its max, and the updated parameters.
    The gradients are the check that separates a fault: the first AdamW
    step at this learning rate moves a parameter by about 1.6e-6, under the
    parameters' 1e-5, whatever the gradient's sign."""
    _, _, results, jax_out = pair
    got = results["meshes"][mesh]["train"]["plain"]
    ref = jax_out[mesh]
    assert abs(got["loss"] - ref["loss"]) <= dry.LOSS_RTOL * max(1.0, abs(ref["loss"]))
    assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=dry.LOSS_RTOL)
    assert got["grads"].keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        err = float((got["grads"][k].double() - want).abs().max())
        assert err <= dry.GRAD_RTOL * float(want.abs().max()), (k, err)
    dmax = max(float((got["params"][k] - v).abs().max()) for k, v in ref["params"].items())
    assert dmax < dry.PARAM_ATOL


@pytest.mark.parametrize("mesh", MESHES)
def test_parallel_greedy_decode_matches_jax_mesh_decode(pair, mesh):
    _, _, results, jax_out = pair
    got = results["meshes"][mesh]["decode"]["chunked"]["tokens"].numpy()
    np.testing.assert_array_equal(got, jax_out[mesh]["tokens"])
    np.testing.assert_array_equal(got, results["ref"]["decode"]["chunked"]["tokens"].numpy())


def test_collectives_give_their_values_on_gloo(pair):
    """all_reduce_, all_gather_cat, broadcast_from_data_root and
    gather_diff_shape (ragged lengths 1 and 2, padded, in rank order) on
    every rank."""
    _, reports, _, _ = pair
    for rep in reports:
        assert rep["collectives"] == {"device": "cpu", "all_reduce": True, "all_gather": True,
                                      "broadcast": True, "gather_diff_shape": True}


def test_planted_copy_to_model_fault_is_caught(pair):
    """copy_to_model without its backward all-reduce leaves each model rank
    a partial gradient of everything before a column-split matmul: the
    replicated parameters' gradients differ from one process's, and the
    comparison says so on every rank."""
    _, reports, _, _ = pair
    for rep in reports:
        fault = rep["planted_fault"]
        assert fault["caught"] and not fault["ok"], fault
        assert fault["replicated_grads_off"] > 0 and fault["grad_rel_err_max"] > 1e-2


def test_cli_ranks_load_disjoint_contiguous_slices(pair):
    """Each rank's steps hold its contiguous slice of the one-process
    epoch's permutation; the slices are disjoint and cover the epoch."""
    _, reports, _, _ = pair
    one = DistInfiniteBatchSampler(world_size=1, rank=0, dataset_len=dry.CLI_TRAIN,
                                   glb_batch_size=dry.CLI_BATCH, same_seed_for_all_ranks=0)
    epoch = one.indices
    seen = [sum(rep["cli"]["steps"], []) for rep in reports]
    half = len(epoch) // 2
    assert seen[0] == epoch[:half] and seen[1] == epoch[half:]
    assert not set(seen[0]) & set(seen[1])
    assert set(seen[0]) | set(seen[1]) == set(range(dry.CLI_TRAIN))
    assert all(rep["cli"]["iters"] == dry.CLI_TRAIN // dry.CLI_BATCH for rep in reports)


def test_cli_eval_sums_reduce_to_one_process(pair):
    """The logged val stats (uneven 3 | 2 split of 5 images, batches of 2,
    rank 1 padding its second batch) equal one process's eval of the same
    parameters over the whole val set."""
    _, reports, _, _ = pair
    for rep in reports:
        cli = rep["cli"]
        assert cli["val"][4] == cli["val_single"][4] == dry.CLI_VAL
        np.testing.assert_allclose(cli["val"][:4], cli["val_single"][:4], rtol=1e-5, atol=1e-6)
    assert reports[0]["cli"]["val"] == reports[1]["cli"]["val"]


def test_cli_only_rank0_writes(pair):
    _, reports, _, _ = pair
    files0, files1 = (rep["cli"]["files"] for rep in reports)
    assert {"ar-ckpt-last.pth", "log.txt"} <= set(files0)
    assert files1 == []
    assert dry.failures(reports) == []


@pytest.mark.parametrize("heads,mp", [(4, 2), (2, 2), (4, 4), (6, 2)])
def test_mesh_geometry_picks_the_kernel_as_jax(monkeypatch, heads, mp):
    """Under a model axis the paired training kernel (row 6) and the decode
    kernels (rows 2, 4) run on this rank's heads at every geometry, an odd
    count a rank too (1 or 3 here): they take one head a CUDA block, where
    JAX's paired kernels want pairs and send such a mesh to XLA
    (``var.py:271-282``, ``:374``, ``:441``; ROADMAP Queue C). A mesh
    object without process groups stands in for model rank 0 (its
    collectives are identities): only the choice is checked here."""
    var = _tiny_var(h=heads, c=64 * heads)
    mesh = pm.Mesh(dp=1, mp=mp)
    pm.shard_var_params(mesh, var)
    calls = []
    for name in ("flash_attention_paired_train", "flash_decode", "flash_decode_paired"):
        real = getattr(tvar, name)
        monkeypatch.setattr(tvar, name, lambda *a, _n=name, _r=real, **k: (calls.append(_n),
                                                                           _r(*a, **k))[1])
    x = torch.randn(2, var.cfg.seq_len, var.cfg.embed_dim)
    tvar.train_attn_apply(var.blocks[0].attn, var.cfg, x, (1, 5), False, "paired", mesh)
    with torch.inference_mode():
        ctx = tvar.cond_context(var, var.class_emb.weight[torch.tensor([1, 2])], torch.float32,
                                mesh)
        for paired in (False, True):
            cache = tvar.init_prealloc_caches(var.cfg, 2, torch.float32, "cpu", paired=paired,
                                              mesh=mesh)
            assert cache.k.shape[-1] == 64 * heads // mp
            tvar.transformer_stage(var, x[:, :1], ctx, cache, torch.float32, mesh)
    want = ["flash_attention_paired_train"] + ["flash_decode"] * 2 + ["flash_decode_paired"] * 2
    assert calls == want
