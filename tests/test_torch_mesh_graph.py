"""The compiled programs under a mesh (``parallel/mesh.py::capturable``), on
the CPU.

Under a mesh whose process groups are NCCL's the port compiles the training
step, the eval step and the samplers as it does in one process; under gloo
they run eagerly. The CPU has no NCCL, so here the decision is read through
``dist.get_backend`` patched to answer ``nccl``, over two one-rank gloo
groups of a one-process world made in this process: their collectives are
identities, and a compiled program on the CPU runs its body over its
static buffers, which must give the eager body's bits. A gloo pair of
processes (``apps/dryrun_multigpu.py``) must still run every program
eagerly and still match JAX's mesh step and decode.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

from var_tpu_torch.apps import dryrun_multigpu as dry
from var_tpu_torch.config import TrainArgs
from var_tpu_torch.engine import sampler as tsm
from var_tpu_torch.engine import trainer as tr
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.parallel import mesh as pm

from .test_torch_parallel import _jax_runs

torch.set_num_threads(2)

SPEC = dry.tiny_spec(1, "cpu", "gloo")  # depth 2, C 64, H 4, V 64, pn 1_2_3, batch 2
CPU = torch.device("cpu")


class _Group:
    def __init__(self, backend):
        self.backend = backend


@pytest.mark.parametrize("case,want", [
    ("none", True), ("no_groups", True), ("nccl", True), ("model_only_nccl", True),
    ("gloo", False), ("nccl_and_gloo", False)])
def test_capturable_reads_each_groups_backend(monkeypatch, case, want):
    """True without a mesh, for a mesh without groups and for one whose every
    group is NCCL's; False as soon as one group is gloo's."""
    monkeypatch.setattr(dist, "get_backend", lambda g: g.backend)
    mesh = {"none": None, "no_groups": pm.Mesh(),
            "nccl": pm.Mesh(2, 2, 0, 0, _Group("nccl"), _Group("nccl")),
            "model_only_nccl": pm.Mesh(1, 2, 0, 0, None, _Group("nccl")),
            "gloo": pm.Mesh(2, 1, 0, 0, _Group("gloo"), None),
            "nccl_and_gloo": pm.Mesh(2, 2, 0, 0, _Group("nccl"), _Group("gloo"))}[case]
    assert pm.capturable(mesh) is want


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) mesh over two one-rank gloo groups of this process."""
    assert not dist.is_initialized()
    store = tmp_path_factory.mktemp("mesh_graph") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield pm.Mesh(1, 1, 0, 0, dist.new_group([0]), dist.new_group([0]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def models():
    return dry.build_models(SPEC, CPU)


def _as(monkeypatch, backend):
    if backend == "nccl":
        monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    assert pm.capturable(pm.Mesh(1, 1, 0, 0, dist.group.WORLD)) is (backend == "nccl")


def _bits(a, b) -> bool:
    return dry._bits_equal([t for t in a if isinstance(t, torch.Tensor)],
                           [t for t in b if isinstance(t, torch.Tensor)])


def _train(mesh, models):
    vae, var_full = models
    var = copy.deepcopy(var_full)
    args = TrainArgs(**dict(SPEC["args"], bs=SPEC["batch"], ac=1)).finalize(world_size=1)
    init_state, step = tr.make_train_step(var.cfg, vae.cfg, args, 4, dtype=torch.float32,
                                          attn_impl="xla", mesh=mesh)
    imgs, labels = dry._batch(SPEC, 1, var.cfg.patch_nums[-1] * vae.cfg.downsample)
    x = (torch.from_numpy(imgs), torch.from_numpy(labels))
    return step, init_state, var, x


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("program", ["train_step", "eval_step", "make_sampler",
                                     "make_sampler_inpainting", "make_sampler_editing",
                                     "make_scan_sampler"])
def test_programs_compile_under_nccl_and_run_eagerly_under_gloo(mesh, models, monkeypatch,
                                                                program, backend):
    """Under groups that report NCCL each program is a ``Compiled`` (its
    entries made) whose calls equal the eager body's
    under the same mesh bit for bit; under gloo it is the eager body. Both
    give the one-process call: training and eval at the dry run's
    tolerances, greedy tokens equal. The inpainting and box-editing
    samplers take ground-truth tokens and a keep or edit mask."""
    _as(monkeypatch, backend)
    vae, var_full = models
    nccl = backend == "nccl"
    if program == "train_step":
        step, init_state, var, x = _train(mesh, models)
        assert (step.program is not None) is nccl
        sa, sb = init_state(var), init_state(copy.deepcopy(var_full))
        for i in range(2):
            sa, ma = step(sa, vae, *x, torch.Generator().manual_seed(i), i, 1.0)
            sb, mb = step.eager(sb, vae, *x, torch.Generator().manual_seed(i), i, 1.0)
            assert _bits(ma, mb) and _bits(sa.tensors(), sb.tensors())
        assert (len(step.program.graphs) if nccl else 0) == int(nccl)
        one, init1, var1, _ = _train(None, models)
        s1 = init1(var1)
        for i in range(2):
            s1, m1 = one(s1, vae, *x, torch.Generator().manual_seed(i), i, 1.0)
        assert abs(float(ma.loss) - float(m1.loss)) <= dry.LOSS_RTOL * max(1.0, float(m1.loss))
        perr = max(float((a - b).abs().max()) for a, b in zip(sa.var.state_dict().values(),
                                                               s1.var.state_dict().values()))
        assert perr < dry.PARAM_ATOL
        return
    var = copy.deepcopy(var_full).eval()
    labels = torch.arange(SPEC["batch"]) % SPEC["var"]["num_classes"]
    if program == "eval_step":
        ev = tr.make_eval_step(var.cfg, vae.cfg, dtype=torch.float32, attn_impl="xla", mesh=mesh)
        assert isinstance(ev, Compiled) is nccl
        imgs, _ = dry._batch(SPEC, 1, var.cfg.patch_nums[-1] * vae.cfg.downsample)
        x = (torch.from_numpy(imgs[0]), labels, torch.tensor([1.0, 0.0]))
        got = [ev(var, vae, *x) for _ in range(2)]
        eager = (ev.eager if nccl else ev)(var, vae, *x)
        assert all(torch.equal(g, eager) for g in got)
        assert (len(ev.graphs) if nccl else 0) == int(nccl)
        one = tr.make_eval_step(var.cfg, vae.cfg, dtype=torch.float32, attn_impl="xla")(
            var, vae, *x)
        np.testing.assert_allclose(got[0].numpy(), one.numpy(), rtol=dry.LOSS_RTOL)
        return
    kw = dict(cfg_scale=SPEC["decode"]["cfg_scale"], top_k=1, dtype=torch.float32)
    if program.startswith("make_sampler"):
        branch = program[len("make_sampler_"):]
        cond, masks = (), {}
        if branch:
            gt = torch.arange(SPEC["batch"] * var.cfg.seq_len).reshape(SPEC["batch"], -1) % 64
            mask = (torch.arange(var.cfg.seq_len) % 3 == 0).expand(SPEC["batch"], -1) \
                if branch == "inpainting" else torch.tensor([[1.0, 0.0], [0.0, 1.0]])
            cond, masks = (gt, mask), {"gt_tokens": gt, ("keep_mask" if branch == "inpainting"
                                                         else "edit_mask"): mask}
        opts = {branch: True} if branch else {}
        sampler = tsm.make_sampler(var.cfg, vae.cfg, device="cpu", mesh=mesh, **opts, **kw)
        got = [sampler(var, vae, torch.Generator().manual_seed(5), labels, *cond)
               for _ in range(2)]
        with torch.inference_mode():
            eager = tsm.decode_cfg(var, vae, labels, torch.Generator().manual_seed(5),
                                   mesh=mesh, **masks, **kw)
        one = tsm.make_sampler(var.cfg, vae.cfg, device="cpu", **opts, **kw)(
            var, vae, torch.Generator().manual_seed(5), labels, *cond)
    else:
        sampler = tsm.make_scan_sampler(var.cfg, vae.cfg, 2, device="cpu", mesh=mesh, **kw)
        rounds = torch.stack([labels, labels.flip(0)])
        got = [sampler(var, vae, torch.Generator().manual_seed(5), rounds) for _ in range(2)]
        with torch.inference_mode():
            parts = [tsm.decode_cfg(var, vae, rounds[r], tsm.fold_in(
                torch.Generator().manual_seed(5), r), mesh=mesh, **kw) for r in range(2)]
        eager = tsm.DecodeResult(*(torch.stack(t) for t in zip(*parts)))
        one = tsm.make_scan_sampler(var.cfg, vae.cfg, 2, device="cpu", **kw)(
            var, vae, torch.Generator().manual_seed(5), rounds)
    assert len(sampler.graphs) == int(nccl)
    assert all(_bits(g, eager) for g in got)
    assert torch.equal(got[0].tokens, one.tokens)


def test_mesh_train_body_reads_nothing_back_to_the_host(mesh, models, monkeypatch):
    """The compiled step under NCCL groups (the flat gradient all-reduce,
    the model group's norm, the metrics' mean) runs again on its entry's
    buffers with every host read and every tensor made from host data
    patched to raise, as ``test_torch_compiled_train.py`` holds the
    one-process bodies: a capture allows none of them."""
    from .test_torch_compiled_train import _HOST_READS, _HOST_WRITES

    _as(monkeypatch, "nccl")
    vae, _ = models
    step, init_state, var, x = _train(mesh, models)
    step(init_state(var), vae, *x, torch.Generator().manual_seed(0), 0, 1.0)
    (entry,) = step.program.graphs.values()

    def refuse(what):
        def raise_(*a, **k):
            raise AssertionError(f"the body called {what}")
        return raise_

    with monkeypatch.context() as m:
        for n in _HOST_READS:
            m.setattr(torch.Tensor, n, refuse(f"Tensor.{n}"))
        for n in _HOST_WRITES:
            m.setattr(torch, n, refuse(f"torch.{n}"))
        entry.body(torch.Generator().manual_seed(1))


def test_mesh_train_body_marks_the_allreduce(mesh, models, monkeypatch):
    """Under a data group the step's body marks the flat gradient all-reduce
    between the backward and the optimizer: a host range of the eager step
    under a profiler (gloo), and one stamp more than one process's seven
    where a capture records the body (NCCL)."""
    from torch.profiler import profile

    from var_tpu_torch.utils.profiling import Recording

    vae, _ = models
    step, init_state, var, x = _train(mesh, models)
    with profile() as prof:
        step(init_state(var), vae, *x, torch.Generator().manual_seed(0), 0, 1.0)
    assert "allreduce" in {e.name for e in prof.events()}
    _as(monkeypatch, "nccl")
    step, init_state, var, (imgs, labels) = _train(mesh, models)
    launched = []
    with Recording(CPU, "train_step", launch=lambda: launched.append(1)) as layout:
        step.program.eager(init_state(var), vae, imgs, labels, torch.tensor([1e-4, 0.05, 1.0]),
                           generator=torch.Generator().manual_seed(0))
    assert [s[0] for s in layout.spans] == ["train_step", "tokenize", "forward", "backward",
                                            "allreduce", "optimizer", "metrics"]
    assert len(launched) == layout.n == 8


def test_model_group_norm_sums_as_the_mask_did(mesh, models):
    """The clipping norm under a model group sums the sharded and the
    replicated squares by device index lists made with the optimizer: the
    same bits as boolean masks over the same squares, which read their
    count back to the host."""
    _, var_full = models
    var = copy.deepcopy(var_full)
    opt = tr.make_adamw(var, 2.0, pm.Mesh(1, 2, 0, 0, None, mesh.model_group))
    grads = [torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
             for i, p in enumerate(var.parameters())]
    sq = torch.stack([g.float().pow(2).sum() for g in grads])
    shard = torch.tensor(opt.sharded)
    want = torch.stack([sq[shard].sum(), sq[~shard].sum() / 2]).sum().sqrt()
    assert any(opt.sharded) and not all(opt.sharded)
    assert torch.equal(opt.global_norm(grads), want)


@pytest.fixture(scope="module")
def gloo_pair(tmp_path_factory):
    """(reports, rank 0's results, JAX's results) of a gloo pair running the
    plain training case and the chunked decode at (2, 1) and (1, 2)."""
    spec = dict(SPEC, batch=4, meshes=[[2, 1], [1, 2]], train=[{"name": "plain", "ac": 1}],
                plant=False, cli=False, save=True)
    out = str(tmp_path_factory.mktemp("gloo_pair"))
    run = dry.launch(spec, 2, out, timeout=300)
    try:
        vae, var = dry.build_models(spec, CPU)
        jax_out = _jax_runs(spec, vae, var)
    finally:
        reports, results = run.wait()
    return reports, results, jax_out


@pytest.mark.parametrize("mesh_name", ["2x1", "1x2"])
def test_gloo_pair_runs_eagerly_and_matches_jax(gloo_pair, mesh_name):
    """Over gloo every rank runs its step and decode eagerly (no held
    program in any case: a host collective cannot be captured), each within
    the dry run's tolerances of one process, and rank 0's step and greedy
    decode match JAX's ``make_train_step(mesh=...)`` and mesh decode."""
    reports, results, jax_out = gloo_pair
    for rep in reports:
        for name, case in rep["meshes"][mesh_name].items():
            assert case["ok"] and "program" not in case, (rep["rank"], name)
    got, ref = results["meshes"][mesh_name], jax_out[mesh_name]
    train = got["train"]["plain"]
    assert abs(train["loss"] - ref["loss"]) <= dry.LOSS_RTOL * max(1.0, abs(ref["loss"]))
    for k, want in ref["grads"].items():
        err = float((train["grads"][k].double() - want).abs().max())
        assert err <= dry.GRAD_RTOL * float(want.abs().max()), (k, err)
    assert max(float((train["params"][k] - v).abs().max())
               for k, v in ref["params"].items()) < dry.PARAM_ATOL
    np.testing.assert_array_equal(got["decode"]["chunked"]["tokens"].numpy(), ref["tokens"])
