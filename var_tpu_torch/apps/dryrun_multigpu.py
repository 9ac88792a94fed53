"""Multi-process dry run of the port's data and tensor parallelism
(counterpart of ``__graft_entry__.py::dryrun_multichip`` and
``_dryrun_impl``, :30-200):

    python -m var_tpu_torch.apps.dryrun_multigpu --n 4                  # nccl, a card each
    python -m var_tpu_torch.apps.dryrun_multigpu --n 2 --device cpu     # gloo, CPU

It starts n processes, joined through a file store in a temporary
directory (no port), and runs every (dp, mp) factorisation of n. In each,
every rank runs the training step (tokenize, forward, backward, gradient
all-reduce, clip, AdamW) and greedy CFG decodes with the batch over
``data`` and the heads over ``model``, and holds them against the same
calls in one process (mesh None), which it runs itself first. The
tolerances are the JAX dry run's (``__graft_entry__.py:184-198``): the
loss within 1e-5 relative, the updated parameters max |diff| < 1e-5, the
greedy tokens equal; the step's gradients, which a first AdamW step at the
dry run's learning rate moves the parameters too little to show, within
1e-4 of each tensor's max |grad|, the norm of the repository's card-vs-CPU
checks. A planted fault (``copy_to_model`` without its backward all-reduce)
must fail that comparison.

Under NCCL (``--device cuda``, the default) the programs under a mesh are
CUDA graphs, as in one process (``parallel/mesh.py::capturable``), and
every case runs its program compiled and eagerly (``HOLD_CALLS`` calls
each, from the same state and generator state, under deterministic
algorithms): each replay must equal its eager run bit for bit, and the
last call both ways the one-process call (its own replay) at the
tolerances above. An eval batch (the last global row padding) joins the
cases there, its sums within ``LOSS_RTOL`` and its accuracies within
``EVAL_ACC_FLIPS`` flipped argmaxes. Each case reports its captured
entries, capture s, pool GB, replay and eager ms and the launches a
replay and an eager call make. Under gloo the programs run eagerly and
each case runs once.

The default configuration is the JAX dry run's tiny one (depth 2, C 64,
H 4, V 64, pn 1_2_3, ``attn_l2_norm``, global batch 2n); :func:`launch`
takes any spec (``chip_smoke.py`` runs the d16 width on one card with two
gloo ranks).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

LOSS_RTOL = 1e-5  # |loss - ref| <= LOSS_RTOL * max(1, |ref|)
PARAM_ATOL = 1e-5  # max |param - ref| < PARAM_ATOL
GRAD_RTOL = 1e-4  # max |grad - ref| <= GRAD_RTOL * max |ref| per tensor
EVAL_ACC_FLIPS = 2  # eval accuracy sums: within this many flipped argmaxes of a row
HOLD_CALLS = 3  # calls of a held case: the first captures, the rest replay
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def factorisations(n: int) -> List[List[int]]:
    """[dp, mp] for mp in 1, 2, 4, ... dividing n (the JAX dry run's shapes)."""
    return [[n // mp, mp] for mp in (1, 2, 4, 8) if mp <= n and n % mp == 0]


def tiny_spec(n: int, device: str = "cuda", backend: str = "nccl") -> dict:
    """The JAX dry run's tiny configuration over n processes: two training
    cases (``drop``: cond-drop and drop-path on, ac 2; ``plain``: neither,
    ac 1, the JAX mesh step's), a chunked greedy decode, the planted fault
    and the CLI case. On a GPU the width is 256 (head_dim 64, the only one
    the kernels take) and training attends through ``paired`` (row 6)."""
    pns = [1, 2, 3]
    gpu = device != "cpu"
    return {
        "device": device, "backend": backend, "seed": 0, "batch": 2 * n,
        "attn": "paired" if gpu else "xla", "threads": 2,
        "vae": dict(vocab_size=64, z_channels=8, ch=32, ch_mult=[1, 1], v_patch_nums=pns),
        "var": dict(num_classes=10, depth=2, embed_dim=256 if gpu else 64, num_heads=4,
                    patch_nums=pns, vocab_size=64, z_channels=8, attn_l2_norm=True,
                    cond_drop_rate=0.0, drop_path_rate=0.0),
        "args": dict(depth=2, ep=2, pn="1_2_3"),
        "meshes": factorisations(n),
        "train": [{"name": "drop", "cond_drop_rate": 0.1, "drop_path_rate": 0.1, "ac": 2},
                  {"name": "plain", "ac": 1}],
        "decode": {"cache_impls": ["chunked"], "cfg_scale": 2.0, "top_k": 1},
        "plant": True, "cli": True, "save": False, "hold": backend == "nccl",
    }


# ---------------------------------------------------------------------------
# what every rank runs


def _configs(spec: dict):
    from var_tpu_torch.config import VAEConfig, VARConfig

    vae_kw = dict(spec["vae"], ch_mult=tuple(spec["vae"]["ch_mult"]),
                  v_patch_nums=tuple(spec["vae"]["v_patch_nums"]))
    return VAEConfig(**vae_kw), VARConfig(**dict(spec["var"],
                                                 patch_nums=tuple(spec["var"]["patch_nums"])))


def build_models(spec: dict, dev: torch.device):
    """The seeded tokenizer and VAR (full, float32) on ``dev``: the same
    weights in every process of one device type. The VAR's tensors that
    its init leaves at zero (the biases, q_bias and v_bias) get seeded
    noise of std 0.02, so that their shards, and the row-split biases added
    once after the all-reduce, show in the comparisons."""
    from var_tpu_torch.models import vae as vae_mod
    from var_tpu_torch.models import var as var_mod

    vae_cfg, var_cfg = _configs(spec)
    gen = torch.Generator(device=dev).manual_seed(spec["seed"])
    vae = vae_mod.init_vae_params(vae_mod.VQVAE(vae_cfg).to(dev), gen)
    var = var_mod.init_var_params(var_mod.VAR(var_cfg).to(dev), gen)
    with torch.no_grad():
        for p in var.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=gen)
    return vae.eval().requires_grad_(False), var.train()


def _batch(spec: dict, ac: int, reso: int):
    rng = np.random.default_rng([spec["seed"], ac])
    imgs = rng.uniform(-1, 1, (ac, spec["batch"], reso, reso, 3)).astype(np.float32)
    labels = (np.arange(ac * spec["batch"]) % spec["var"]["num_classes"]).reshape(ac, -1)
    return imgs, labels


def _kernels():
    from var_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                        flash_attention_fwd, flash_decode,
                                                        flash_decode_paired, paired_train_bwd,
                                                        paired_train_fwd)
    from var_tpu_torch.ops.cuda.fused_ln import modulated_layernorm
    from var_tpu_torch.ops.cuda.kv_write import kv_write
    from var_tpu_torch.ops.cuda.select import topk_topp_bound

    return (modulated_layernorm, flash_decode, topk_topp_bound, flash_decode_paired,
            flash_attention_fwd, flash_attention_bwd, paired_train_fwd, paired_train_bwd,
            kv_write)


@contextlib.contextmanager
def _counted(out: dict):
    """Launches of each kernel wrapper inside the block, into ``out``."""
    before = {fn.__name__: fn.launches for fn in _kernels()}
    yield
    out.update({fn.__name__: fn.launches - before[fn.__name__] for fn in _kernels()})


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(fn(), host ms of the call), synchronised on both sides."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def _bits_equal(a, b) -> bool:
    """Two sequences of tensors equal bit for bit (NaN where NaN)."""
    def eq(x, y):
        if x.is_floating_point():
            return torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                     y.nan_to_num())
        return torch.equal(x, y)
    return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))


def _held_row(program, held, ms: dict, launches: dict) -> dict:
    """What a held case reports of its compiled program: the held calls,
    its entries, capture s and pool GB, the median ms of its replays and of
    the eager calls after the first, and one replay's and one eager call's
    launches."""
    entries = list(program.graphs.values())
    return {"held": held, "captured": len(entries),
            "capture_s": [e.capture_s for e in entries], "pool_gb": _pool_gb(program),
            "replay_ms": float(np.median(ms["replay"][1:])),
            "eager_ms": float(np.median(ms["eager"][1:])),
            "launches_replay": launches["replay"], "launches_eager": launches["eager"]}


def _pool_gb(program) -> Optional[float]:
    """The GB the entries of a compiled program reserved at their captures
    (None: an eager program, or none captured)."""
    entries = list(getattr(program, "graphs", {}).values())
    return sum(e.pool_bytes for e in entries) / 1e9 if entries else None


def _gen(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def train_case(spec: dict, case: dict, mesh, vae, var_full, dev) -> dict:
    """Steps of ``case`` on a fresh copy of ``var_full`` (sharded for
    ``mesh``): one, or HOLD_CALLS with ``spec["hold"]``, when a compiled
    step under a mesh also runs on a second copy through ``step.eager``
    from the same generator states. Returns the last step's loss, metrics,
    the whole model's averaged gradients and updated parameters (gathered),
    the first step's launches, this rank's head count, and ``program``
    (:func:`_held_row`) where held."""
    from var_tpu_torch.config import TrainArgs
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.parallel import mesh as pm

    dp = 1 if mesh is None else mesh.dp
    ac = case.get("ac", 1)
    cfg = dataclasses.replace(var_full.cfg, cond_drop_rate=case.get("cond_drop_rate", 0.0),
                              drop_path_rate=case.get("drop_path_rate", 0.0))

    def fresh():
        var = pm.shard_var_params(mesh, copy.deepcopy(var_full))
        var.cfg = cfg
        return var

    args = TrainArgs(**dict(spec["args"], bs=spec["batch"] * ac, ac=ac)).finalize(world_size=dp)
    dtype = getattr(torch, spec.get("dtype", "float32"))
    init_state, step = tr.make_train_step(cfg, vae.cfg, args, iters_per_ep=4, dtype=dtype,
                                          attn_impl=spec["attn"], mesh=mesh)
    reso = cfg.patch_nums[-1] * vae.cfg.downsample
    imgs, labels = _batch(spec, ac, reso)
    row0, _ = pm.data_rows(mesh, spec["batch"] // dp)
    rows = slice(row0, row0 + spec["batch"] // dp)
    x = (torch.from_numpy(imgs[:, rows]).to(dev), torch.from_numpy(labels[:, rows]).to(dev))
    hold = bool(spec.get("hold")) and mesh is not None and step.program is not None
    st = {"replay": init_state(fresh())}
    if hold:
        st["eager"] = init_state(fresh())
    fns = {"replay": step, "eager": step.eager}
    ms: Dict[str, list] = {"replay": [], "eager": []}
    launches: Dict[str, dict] = {}
    held = []
    for i in range(HOLD_CALLS if spec.get("hold") else 1):
        out = {}
        for kind in st:  # g_it i: lr and wd differ from call to call
            gen = _gen(dev, spec["seed"] + 1 + i)
            counted: Dict[str, int] = {}
            with _counted(counted):
                (st[kind], m), t = _timed(dev, lambda: fns[kind](st[kind], vae, *x, gen, i, 1.0))
            out[kind] = (m, gen, counted)
            ms[kind].append(t)
            launches.setdefault("first" if i == 0 else kind, counted)
        if hold:
            (m, gen, _), (me, ge, _) = out["replay"], out["eager"]
            a, b = st["replay"], st["eager"]
            held.append({
                "call": i, "replay": i > 0,
                "metrics_equal": _bits_equal([v for v in m if isinstance(v, torch.Tensor)],
                                             [v for v in me if isinstance(v, torch.Tensor)]),
                "state_equal": _bits_equal(a.tensors(), b.tensors()),
                "grads_equal": _bits_equal([p.grad for p in a.var.parameters()],
                                           [p.grad for p in b.var.parameters()]),
                "generator_equal": bool(torch.equal(gen.get_state(), ge.get_state()))})
    state, m = st["replay"], out["replay"][0]
    grads = pm.gather_state_dict(mesh, {n: p.grad for n, p in state.var.named_parameters()})
    params = pm.gather_var_state_dict(mesh, state.var)
    res = {"loss": float(m.loss), "grad_norm": float(m.grad_norm), "Lm": float(m.Lm),
           "pred_hist": m.pred_hist.cpu(),
           "grads": {k: v.cpu() for k, v in grads.items()},
           "params": {k: v.cpu() for k, v in params.items()}, "launches": launches["first"],
           "heads_local": cfg.num_heads // (1 if mesh is None else mesh.mp),
           "pool_gb": _pool_gb(step.program)}
    if hold:
        res["program"] = _held_row(step.program, [all(v for k, v in r.items() if k.endswith(
            "_equal")) for r in held], ms, launches)
        res["program"]["held_rows"] = held
    return res


def eval_case(spec: dict, mesh, vae, var_full, dev) -> dict:
    """HOLD_CALLS eval batches of the global batch (its last row padding,
    valid 0) through ``make_eval_step`` (the eval attention of
    ``spec["attn"]``), each rank passing its data rank's rows: the sums of
    the last call, and under a mesh with a compiled program the eager
    body's of each call beside them (``program``)."""
    from var_tpu_torch.engine import trainer as tr
    from var_tpu_torch.parallel import mesh as pm

    dp = 1 if mesh is None else mesh.dp
    var = pm.shard_var_params(mesh, copy.deepcopy(var_full)).eval()
    ev = tr.make_eval_step(var.cfg, vae.cfg, dtype=getattr(torch, spec.get("dtype", "float32")),
                           attn_impl=tr.pick_eval_attn(spec["attn"], var.cfg.seq_len),
                           mesh=mesh)
    imgs, labels = _batch(spec, 1, var.cfg.patch_nums[-1] * vae.cfg.downsample)
    valid = np.ones(spec["batch"], np.float32)
    valid[-1] = 0.0
    row0, _ = pm.data_rows(mesh, spec["batch"] // dp)
    rows = slice(row0, row0 + spec["batch"] // dp)
    x = [torch.from_numpy(a[rows]).to(dev) for a in (imgs[0], labels[0], valid)]
    hold = mesh is not None and hasattr(ev, "eager")
    fns = {"replay": ev, "eager": ev.eager} if hold else {"replay": ev}
    ms: Dict[str, list] = {k: [] for k in fns}
    launches: Dict[str, dict] = {}
    held, sums = [], {}
    for i in range(HOLD_CALLS):
        for kind, fn in fns.items():
            counted: Dict[str, int] = {}
            with _counted(counted):
                sums[kind], t = _timed(dev, lambda: fn(var, vae, *x))
            ms[kind].append(t)
            launches.setdefault("first" if i == 0 else kind, counted)
        if hold:
            held.append(_bits_equal([sums["replay"]], [sums["eager"]]))
    res = {"sums": sums["replay"].double().cpu(), "last_l": var.cfg.patch_nums[-1] ** 2,
           "launches": launches["first"], "pool_gb": _pool_gb(ev)}
    if hold:
        res["program"] = _held_row(ev, held, ms, launches)
    return res


def decode_case(spec: dict, cache_impl: str, mesh, vae, var_full, dev) -> dict:
    """A greedy CFG decode of the global batch through ``make_sampler``:
    once, or HOLD_CALLS times with ``spec["hold"]``, when under a mesh with
    a compiled sampler each call is held against the eager
    :func:`decode_cfg` from the same generator state (``program``)."""
    from var_tpu_torch.engine.sampler import decode_cfg, make_sampler
    from var_tpu_torch.parallel import mesh as pm

    var = pm.shard_var_params(mesh, copy.deepcopy(var_full)).eval()
    d = spec["decode"]
    kw = dict(cfg_scale=d["cfg_scale"], top_k=d["top_k"],
              dtype=getattr(torch, spec.get("dtype", "float32")), cache_impl=cache_impl,
              mesh=mesh)
    sampler = make_sampler(var.cfg, vae.cfg, device=dev, **kw)
    labels = torch.from_numpy(np.arange(spec["batch"]) % spec["var"]["num_classes"]).to(dev)

    def eager(gen):
        with torch.inference_mode():
            return decode_cfg(var, vae, labels, gen, **kw)

    fns = {"replay": lambda gen: sampler(var, vae, gen, labels), "eager": eager}
    hold = bool(spec.get("hold")) and mesh is not None and pm.capturable(mesh)
    if not hold:
        fns.pop("eager")
    ms: Dict[str, list] = {k: [] for k in fns}
    launches: Dict[str, dict] = {}
    held, res = [], {}
    for i in range(HOLD_CALLS if spec.get("hold") else 1):
        gens = {}
        for kind, fn in fns.items():
            gens[kind] = _gen(dev, 5 + i)
            counted: Dict[str, int] = {}
            with _counted(counted):
                res[kind], t = _timed(dev, lambda: fn(gens[kind]))
            ms[kind].append(t)
            launches.setdefault("first" if i == 0 else kind, counted)
        if hold:
            held.append(_bits_equal(list(res["replay"]), list(res["eager"]))
                        and bool(torch.equal(gens["replay"].get_state(),
                                             gens["eager"].get_state())))
    out = {"tokens": res["replay"].tokens.cpu(), "f_hat": res["replay"].f_hat.cpu(),
           "launches": launches["first"], "pool_gb": _pool_gb(sampler)}
    if hold:
        out["program"] = _held_row(sampler, held, ms, launches)
    return out


def run_cases(spec: dict, mesh, vae, var_full, dev) -> dict:
    out = {"train": {c["name"]: train_case(spec, c, mesh, vae, var_full, dev)
                     for c in spec["train"]}}
    out["decode"] = {impl: decode_case(spec, impl, mesh, vae, var_full, dev)
                     for impl in spec["decode"]["cache_impls"]}
    if spec.get("hold"):
        out["eval"] = eval_case(spec, mesh, vae, var_full, dev)
    return out


def _program_ok(g: dict, r: dict) -> dict:
    """A held case's program report beside the one-process program's pool
    GB, and whether it passed: every call bit for bit, at least one entry
    captured, a replay launching as an eager call."""
    if "program" not in g:
        return {}
    p = dict(g["program"], pool_gb_one_process=r.get("pool_gb"))
    return {"program": p, "program_ok": all(p["held"]) and p["captured"] >= 1
            and p["launches_replay"] == p["launches_eager"]}


def compare(ref: dict, got: dict) -> dict:
    """Per case: the errors against the one-process run, and ``ok``."""
    from var_tpu_torch.parallel.mesh import is_sharded

    report = {}
    for name, r in ref["train"].items():
        g = got["train"][name]
        loss_err = abs(g["loss"] - r["loss"]) / max(1.0, abs(r["loss"]))
        norm_err = abs(g["grad_norm"] - r["grad_norm"]) / max(1e-30, abs(r["grad_norm"]))
        param_err = max(float((g["params"][k] - v).abs().max()) for k, v in r["params"].items())
        grad_errs = {k: float((g["grads"][k] - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                     for k, v in r["grads"].items()}
        worst = max(grad_errs, key=lambda k: grad_errs[k])
        bad = sorted(k for k, e in grad_errs.items() if not e <= GRAD_RTOL)
        # the logged metrics are the global batch's: Lm as the loss, the
        # argmax histogram over every position (one near-tie argmax may flip)
        lm_err = abs(g["Lm"] - r["Lm"]) / max(1.0, abs(r["Lm"]))
        hist_l1 = int((g["pred_hist"] - r["pred_hist"]).abs().sum())
        hist_ok = g["pred_hist"].sum() == r["pred_hist"].sum() and hist_l1 <= 2
        held = _program_ok(g, r)
        report[f"train_{name}"] = {
            "loss": g["loss"], "loss_ref": r["loss"], "loss_rel_err": loss_err,
            "grad_norm_rel_err": norm_err, "param_max_abs_err": param_err,
            "Lm_rel_err": lm_err, "pred_hist_l1": hist_l1,
            "grad_rel_err_max": grad_errs[worst], "grad_rel_err_param": worst,
            "grads_off": bad[:6], "replicated_grads_off": sum(not is_sharded(k) for k in bad),
            "launches": g["launches"], "heads_local": g["heads_local"], **held,
            "ok": loss_err <= LOSS_RTOL and norm_err <= LOSS_RTOL and param_err < PARAM_ATOL
            and not bad and lm_err <= LOSS_RTOL and bool(hist_ok)
            and held.get("program_ok", True)}
    for impl, r in ref["decode"].items():
        g = got["decode"][impl]
        diff = int((g["tokens"] != r["tokens"]).sum())
        held = _program_ok(g, r)
        report[f"decode_{impl}"] = {
            "tokens_differ": diff, "tokens": int(r["tokens"].numel()),
            "f_hat_max_abs_err": float((g["f_hat"] - r["f_hat"]).abs().max()),
            "launches": g["launches"], **held,
            "ok": diff == 0 and held.get("program_ok", True)}
    if "eval" in ref:
        r, g = ref["eval"], got["eval"]
        loss_err = float(((g["sums"][:2] - r["sums"][:2]).abs()
                          / r["sums"][:2].abs().clamp(min=1.0)).max())
        acc_err = float((g["sums"][2:4] - r["sums"][2:4]).abs().max())
        held = _program_ok(g, r)
        report["eval"] = {
            "sums": g["sums"].tolist(), "sums_ref": r["sums"].tolist(), "loss_rel_err": loss_err,
            "acc_abs_err": acc_err, "launches": g["launches"], **held,
            "ok": loss_err <= LOSS_RTOL and acc_err <= EVAL_ACC_FLIPS * 100.0 / r["last_l"]
            and bool(g["sums"][4] == r["sums"][4]) and held.get("program_ok", True)}
    return report


def _planted_fault(spec: dict, mesh, ref: dict, vae, var_full, dev) -> dict:
    """The first training case with ``copy_to_model``'s backward all-reduce
    taken out: the comparison must fail on the replicated parameters."""
    from var_tpu_torch.parallel import shard_attn as sa

    case = spec["train"][0]
    real = sa._CopyToModel.backward
    sa._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
    try:
        got = train_case(spec, case, mesh, vae, var_full, dev)
    finally:
        sa._CopyToModel.backward = real
    rep = compare({"train": {case["name"]: ref["train"][case["name"]]}, "decode": {}},
                  {"train": {case["name"]: got}, "decode": {}})[f"train_{case['name']}"]
    rep["caught"] = not rep["ok"] and rep["replicated_grads_off"] > 0
    return rep


def collectives_case(dev) -> dict:
    """Each collective of ``parallel/`` over the whole group on ``dev``'s
    tensors (gloo stages CUDA tensors through host memory; reduce-scatter,
    which gloo lacks, is not used), against the values it must give: rank
    r contributes r + 1, its rank, its own value to be overwritten, and r + 1
    rows of 10 r + i (``gather_diff_shape``, as JAX's ``test_gather_diff_shape``)."""
    from var_tpu_torch.parallel import mesh as pm

    rank, n = dist.get_rank(), dist.get_world_size()
    group = pm.make_mesh().data_group
    red = pm.all_reduce_(torch.full((3,), float(rank + 1), device=dev), group)
    gat = pm.all_gather_cat(torch.tensor([rank], device=dev), group)
    mesh = pm.Mesh(dp=n, data_rank=rank, data_group=group)
    bc = torch.full((2,), float(rank), device=dev)
    pm.broadcast_from_data_root(mesh, [bc])
    rows, lengths = pm.gather_diff_shape(
        torch.arange(rank + 1, dtype=torch.float32, device=dev)[:, None] + 10 * rank, group)
    want_rows = torch.zeros(n, n, 1)
    for r in range(n):
        want_rows[r, :r + 1, 0] = torch.arange(r + 1) + 10 * r
    return {"device": str(red.device),
            "all_reduce": red.cpu().tolist() == [n * (n + 1) / 2] * 3,
            "all_gather": gat.cpu().tolist() == list(range(n)),
            "broadcast": bc.cpu().tolist() == [0.0, 0.0],
            "gather_diff_shape": lengths.cpu().tolist() == list(range(1, n + 1))
            and torch.equal(rows.cpu(), want_rows)}


class _IndexImages:
    """A dataset whose image i is the constant i / n (the index read back
    from any pixel), label i % 10."""

    def __init__(self, n: int, reso: int):
        self.samples = [(i, i % 10) for i in range(n)]
        self.n, self.reso = n, reso

    def __len__(self):
        return self.n

    def transform(self, item, rng):
        del rng
        return np.full((self.reso, self.reso, 3), item / self.n, np.float32)


CLI_TRAIN, CLI_VAL, CLI_BATCH = 16, 5, 4


def cli_case(spec: dict, mesh, vae, var_full, dev, out_dir: str) -> dict:
    """The CLI's loader and loop (``apps/train.py``) at dp = n over numpy
    images: one epoch, eval at its end, each rank writing into its own
    folder. Reports the dataset indices of each rank's steps, the logged
    val stats against one process's eval of the same final parameters over
    the whole val set, and the files each rank wrote."""
    from var_tpu_torch.apps import train as train_app
    from var_tpu_torch.config import TrainArgs
    from var_tpu_torch.engine import trainer as tr

    reso = var_full.cfg.patch_nums[-1] * vae.cfg.downsample
    train_ds, val_ds = _IndexImages(CLI_TRAIN, reso), _IndexImages(CLI_VAL, reso)
    rank_dir = os.path.join(out_dir, f"cli_rank{dist.get_rank()}")
    args = TrainArgs(**dict(spec["args"], bs=CLI_BATCH, ac=1, ep=1, workers=2, seed=0,
                            ckpt_iters=0, local_out_dir_path=rank_dir)
                     ).finalize(world_size=mesh.dp)
    train_iter, iters, val_batches = train_app.make_loaders(
        args, train_ds, val_ds, 0, 0, train_ds.transform, val_ds.transform,
        world_size=mesh.dp, rank=mesh.data_rank)
    seen = []

    def recorded(it):
        for imgs, labels in it:
            seen.append(np.rint(imgs[:, 0, 0, 0] * CLI_TRAIN).astype(int).tolist())
            yield imgs, labels

    var = copy.deepcopy(var_full)
    state, times = train_app.train(args, dev, spec["attn"], vae, var, recorded(train_iter),
                                   iters, val_batches, mesh=mesh)
    # one process's eval of the final parameters over the whole val set
    eval_step = tr.make_eval_step(var.cfg, vae.cfg, dtype=torch.float32, attn_impl=spec["attn"])
    imgs = np.stack([val_ds.transform(i, None) for i in range(CLI_VAL)])
    labels = np.array([s[1] for s in val_ds.samples])
    sums = eval_step(state.var, vae, torch.from_numpy(imgs).to(dev),
                     torch.from_numpy(labels).to(dev), torch.ones(CLI_VAL, device=dev)).double()
    single = (sums[:4] / sums[4]).tolist() + [int(sums[4])]
    files = sorted(os.listdir(rank_dir)) if os.path.isdir(rank_dir) else []
    return {"steps": seen, "iters": iters, "val": list(times["val"][-1]), "val_single": single,
            "files": files}


def worker(spec_path: str, store: str, out_dir: str) -> None:
    """One rank: join the group, run the one-process reference, then each
    mesh, the planted fault and the CLI case; write its report."""
    from var_tpu_torch.device import resolve_device
    from var_tpu_torch.parallel import mesh as pm

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 2))
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 parity: TF32 off
    torch.backends.cudnn.allow_tf32 = False
    if spec.get("hold"):  # replays held bit for bit against eager runs: no atomics' order
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    pm.initialize_distributed(spec["backend"], f"file://{store}")
    rank = dist.get_rank()
    dev = resolve_device(spec["device"])
    vae, var = build_models(spec, dev)
    ref = run_cases(spec, None, vae, var, dev)
    report = {"rank": rank, "world": dist.get_world_size(), "meshes": {},
              "collectives": collectives_case(dev)}
    saved = {"ref": ref, "meshes": {}}
    for dp, mp in spec["meshes"]:
        mesh = pm.make_mesh(mp)
        got = run_cases(spec, mesh, vae, var, dev)
        report["meshes"][f"{dp}x{mp}"] = compare(ref, got)
        saved["meshes"][f"{dp}x{mp}"] = got
        pm.barrier()
    tp = [mp for _, mp in spec["meshes"] if mp > 1]
    if spec.get("plant") and tp:
        report["planted_fault"] = _planted_fault(spec, pm.make_mesh(tp[0]), ref, vae, var, dev)
    if spec.get("cli"):
        report["cli"] = cli_case(spec, pm.make_mesh(), vae, var, dev, out_dir)
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
    if spec.get("save") and rank == 0:
        torch.save(saved, os.path.join(out_dir, "results.pt"))
    pm.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the launcher


class Run:
    """n worker processes started by :func:`launch`; :meth:`wait` joins
    them and returns their reports (and rank 0's full results when the
    spec has ``save``)."""

    def __init__(self, procs, out_dir: str, timeout: float):
        self.procs, self.out_dir, self.timeout = procs, out_dir, timeout

    def log(self, rank: int) -> str:
        with open(os.path.join(self.out_dir, f"rank{rank}.log")) as f:
            return f.read()

    def wait(self):
        try:
            for p in self.procs:
                p.wait(timeout=self.timeout)
        finally:
            for p in self.procs:  # no rank outlives the run
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{self.log(r)[-4000:]}")
        reports = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(len(self.procs))]
        saved = os.path.join(self.out_dir, "results.pt")
        results = torch.load(saved, weights_only=False) if os.path.exists(saved) else None
        return reports, results


def launch(spec: dict, n: int, out_dir: str, timeout: float = 600.0,
           local_ranks: Optional[List[int]] = None) -> Run:
    """Start n ranks of :func:`worker` on ``spec``, reporting into
    ``out_dir`` (which must exist and be empty of reports).
    ``local_ranks``: each rank's ``LOCAL_RANK`` (default its rank)."""
    spec_path = os.path.join(out_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, WORLD_SIZE=str(n),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    for r in range(n):
        local = r if local_ranks is None else local_ranks[r]
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "var_tpu_torch.apps.dryrun_multigpu", "--worker",
                 spec_path, store, out_dir], env=dict(env, RANK=str(r), LOCAL_RANK=str(local)),
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
    return Run(procs, out_dir, timeout)


def failures(reports) -> List[str]:
    """What a run's reports fail: a collective with wrong values, a case off
    its tolerance, a planted fault not caught, a CLI case whose val stats
    differ from one process's or whose files are not rank 0's alone."""
    bad = []
    for rep in reports:
        r = rep["rank"]
        bad += [f"rank {r}: {name} on {rep['collectives']['device']} gave the wrong values"
                for name, ok in rep["collectives"].items() if ok is False]
        for mesh, cases in rep["meshes"].items():
            bad += [f"rank {r} mesh {mesh} {name}: {c}" for name, c in cases.items()
                    if not c["ok"]]
        if "planted_fault" in rep and not rep["planted_fault"]["caught"]:
            bad.append(f"rank {r}: planted fault not caught: {rep['planted_fault']}")
        if "cli" in rep:
            cli = rep["cli"]
            if not np.allclose(cli["val"][:4], cli["val_single"][:4], rtol=1e-5, atol=1e-6) \
                    or cli["val"][4] != cli["val_single"][4]:
                bad.append(f"rank {r}: CLI val {cli['val']} != one process {cli['val_single']}")
            if bool(cli["files"]) != (r == 0) or (r == 0 and not {"ar-ckpt-last.pth", "log.txt"}
                                                 <= set(cli["files"])):
                bad.append(f"rank {r}: CLI wrote {cli['files']}")
    return bad


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="processes (every (dp, mp) of n is run)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (rank r on card r), or cpu")
    p.add_argument("--backend", default=None, help="nccl (default on cuda) or gloo")
    p.add_argument("--worker", nargs=3, metavar=("SPEC", "STORE", "OUT"), help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.worker:
        worker(*a.worker)
        return
    from var_tpu_torch.device import resolve_device

    dev = resolve_device(a.device)
    backend = a.backend or ("gloo" if dev.type == "cpu" else "nccl")
    if dev.type == "cuda" and backend != "gloo" and a.n > torch.cuda.device_count():
        raise RuntimeError(f"--n {a.n} ranks but {torch.cuda.device_count()} GPU(s): NCCL "
                           "takes one rank a card; name --backend gloo to share a card, or "
                           "pass --device cpu")
    with tempfile.TemporaryDirectory(prefix="var_dryrun_") as tmp:
        reports, _ = launch(tiny_spec(a.n, a.device, backend), a.n, tmp).wait()
    for rep in reports:
        print(json.dumps({"rank": rep["rank"], "meshes": rep["meshes"],
                          "planted_fault_caught": rep.get("planted_fault", {}).get("caught"),
                          "cli": {k: rep["cli"][k] for k in ("val", "val_single", "files")}
                          if "cli" in rep else None}, default=str))
    bad = failures(reports)
    if bad:
        raise SystemExit("dryrun_multigpu FAILED:\n" + "\n".join(bad))
    print(f"[dryrun_multigpu] n={a.n}: {len(reports[0]['meshes'])} mesh shapes verified OK "
          f"(train steps, greedy decodes, planted fault, CLI)")


if __name__ == "__main__":
    main()
