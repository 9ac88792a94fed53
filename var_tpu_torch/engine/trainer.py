"""VAR training engine: loss, optimizer, train and eval steps (counterpart of
``var_tpu/engine/trainer.py``).

Semantics follow the JAX package (reference ``trainer.py:20-160``,
``utils/lr_control.py:68-108``, ``utils/amp_sc.py:39-75``):

* teacher forcing: frozen-VQVAE tokenize -> quantizer teacher input -> VAR
  forward -> cross entropy (label smoothing) weighted 1/L, summed over L,
  mean over B; progressive training re-weights the newest scale by
  ``prog_wp``;
* the update: global-norm clip (optax's rule: scale by tclip/|g| only when
  |g| >= tclip), then Adam(0.9, 0.95, 1e-8), then decoupled weight decay on
  the >= 2-D weights outside ``NOWD_NAMES``: ``p -= lr * (adam(g) + wd * p)``
  in torch AdamW's order, over fixed moment and count tensors
  (:class:`AdamState`), with lr and wd device scalars;
* ``ac`` micro-batches accumulate gradients with 1/ac loss scaling;
* ``fp16=1`` skips steps whose gradient norm is not finite (parameters,
  Adam's moments and its step count stay as they were: JAX's ``where(finite,
  new, old)``, decided on the device); ``dscale=1`` adds dynamic loss
  scaling with torch-GradScaler semantics, its state device tensors.

Parameters and optimizer state are float32; the forward casts to the compute
dtype at each use (no autocast).

Like the JAX package's jitted steps, :func:`make_train_step`'s step and
:func:`make_eval_step` are compiled programs (``engine/compiled.py``): on
CUDA the first call of a shape runs eagerly and captures a CUDA graph,
later calls replay it; every value that changes from step to step (lr, wd,
prog_wp, the generator state) goes in as a device input, and the body reads
nothing back to the host. On the CPU the same bodies run eagerly. A mesh
with a process group stays eager (a collective over gloo cannot be
captured).

``mesh`` (``parallel/mesh.py``): each data rank steps on its rows of the
global batch; after the micro-batches one flat all-reduce over the data
group averages the gradients (XLA's gradient all-reduce in the JAX
package; ``DistributedDataParallel`` does not fit, since the port calls
functions on submodules and DDP hooks only ``module.forward``). With a
model axis the module holds this rank's shards; the clipping norm counts
the sharded gradients over the model group and the replicated ones once,
so the clip factor, the skip guard and the loss scale agree on every rank.
The metrics are the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from var_tpu_torch.config import TrainArgs, VAEConfig, VARConfig
from var_tpu_torch.engine.compiled import Compiled
from var_tpu_torch.engine.schedules import lr_factor, wd_value
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod
from var_tpu_torch.parallel import mesh as pm

NOWD_NAMES = ("pos_1LC", "pos_start", "lvl_embed", "ada_gss", "scale_mul")


def weight_decay_mask(var: torch.nn.Module) -> Dict[str, bool]:
    """{parameter name: decayed} (reference ``filter_params``: >= 2-D
    weights outside ``NOWD_NAMES``): every Linear weight and the class
    embedding; not biases, positional tables, ada_gss or scale_mul."""
    return {name: name.endswith(".weight") and not any(n in name for n in NOWD_NAMES)
            for name, _ in var.named_parameters()}


Scalar = Union[float, torch.Tensor]


class AdamState(torch.optim.Optimizer):
    """Adam's moments and step count (the state of optax's
    ``scale_by_adam``), made with the optimizer in fixed tensors on the
    parameters' device, so that a captured step updates them in place. One
    float32 count is shared by every parameter's ``"step"`` entry; the
    state dict has torch.optim's layout."""

    def __init__(self, groups, betas=(0.9, 0.95), eps: float = 1e-8):
        super().__init__(groups, dict(betas=betas, eps=eps))
        params = [p for g in self.param_groups for p in g["params"]]
        count = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for p in params:
            self.state[p] = {"step": count, "exp_avg": torch.zeros_like(p),
                             "exp_avg_sq": torch.zeros_like(p)}

    def load_state_dict(self, state_dict) -> None:
        """torch.optim's load (which makes new moment tensors: a captured
        step must capture again), the counts shared again on the device."""
        super().load_state_dict(state_dict)
        states = list(self.state.items())
        p0, s0 = states[0]
        count = s0["step"].to(device=p0.device, dtype=torch.float32).reshape(())
        for _, s in states:
            s["step"] = count

    def tensors(self) -> List[torch.Tensor]:
        return [t for s in self.state.values() for t in s.values()]

    @torch.no_grad()
    def update(self, lr: Scalar, wd: Scalar, ok: torch.Tensor) -> None:
        """``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` from the
        parameters' ``.grad``, wd on the first group only, in torch AdamW's
        order (``p *= 1 - lr * wd``, then ``p -= m / (den / step)``) with
        its bias corrections and step as device scalars, and the moments as
        optax updates them (``m = b1 * m + (1 - b1) * g``). ``ok`` (a device
        bool): where False, nothing moves -- the gradients are zeroed first,
        so the moments keep their values exactly (decays of 1), the count
        does not advance and lr is 0."""
        b1, b2 = self.defaults["betas"]
        eps = self.defaults["eps"]
        count = next(iter(self.state.values()))["step"]
        for p in self.state:
            p.grad.masked_fill_(~ok, 0.0)
        count.add_(ok.float())
        lr = lr * ok
        t = count.clamp(min=1.0)  # a skipped first step leaves the moments at 0
        step = lr / (1.0 - torch.pow(b1, t))  # 0 on a skipped step: den / 0 = inf
        bc2_sqrt = (1.0 - torch.pow(b2, t)).sqrt()
        d1, d2 = torch.where(ok, b1, 1.0), torch.where(ok, b2, 1.0)
        for gi, group in enumerate(self.param_groups):
            params = group["params"]
            if not params:
                continue
            grads = [p.grad for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            if gi == 0 and not (isinstance(wd, (int, float)) and wd == 0):
                torch._foreach_mul_(params, 1.0 - lr * wd)
            torch._foreach_mul_(m, d1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, d2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            den = torch._foreach_sqrt(v)
            torch._foreach_div_(den, bc2_sqrt)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(den, step)
            torch._foreach_addcdiv_(params, m, den, value=-1.0)


class ClippedAdamW:
    """``make_adamw`` (``trainer.py:66``): p -= lr * (adam(clip(g)) + wd * p * mask).
    ``mesh``: the global norm of a model split over its model axis."""

    def __init__(self, var: torch.nn.Module, tclip: float, mesh: Optional[pm.Mesh] = None):
        mask = weight_decay_mask(var)
        named = list(var.named_parameters())
        self.params = [p for _, p in named]
        self.sharded = [pm.is_sharded(n) for n, _ in named]
        self.mesh = mesh
        self.tclip = tclip
        self.opt = AdamState([{"params": [p for n, p in named if mask[n]]},
                              {"params": [p for n, p in named if not mask[n]]}])

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def tensors(self) -> List[torch.Tensor]:
        return self.opt.tensors()

    def grads(self) -> List[torch.Tensor]:
        for p in self.params:  # unused parameters get zero gradients, as under jax.grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return [p.grad for p in self.params]

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """L2 norm of the whole model's gradient. Under a model axis: the
        sharded tensors' squares summed over the model group, the replicated
        ones' counted once (their mean over the group, so every rank gets the
        same bits)."""
        group = None if self.mesh is None else self.mesh.model_group
        if group is None:
            return torch.nn.utils.get_total_norm(grads, norm_type=2.0)
        sq = torch.stack([g.float().pow(2).sum() for g in grads])
        shard = torch.tensor(self.sharded, device=sq.device)
        parts = torch.stack([sq[shard].sum(), sq[~shard].sum() / self.mesh.mp])
        return pm.all_reduce_(parts, group).sum().sqrt()

    def step(self, lr: Scalar, wd: Scalar, skip_nonfinite: bool):
        """Clip, then step. ``lr`` and ``wd``: numbers, or device scalars (a
        captured step's inputs). Returns (global grad norm before clipping,
        stepped: a device bool, False where the guard skipped the step)."""
        grads = self.grads()
        gnorm = self.global_norm(grads)
        if self.tclip > 0:
            factor = torch.where(gnorm < self.tclip, torch.ones_like(gnorm), self.tclip / gnorm)
            torch._foreach_mul_(grads, factor)
        ok = torch.isfinite(gnorm) if skip_nonfinite else torch.ones_like(gnorm, dtype=torch.bool)
        self.opt.update(lr, wd, ok)
        return gnorm, ok


def make_adamw(var: torch.nn.Module, tclip: float,
               mesh: Optional[pm.Mesh] = None) -> ClippedAdamW:
    return ClippedAdamW(var, tclip, mesh)


def make_grad_scaler(init_scale: float = 2.0 ** 11, growth_interval: int = 1000,
                     max_scale: float = 32768.0, min_scale: float = 1.0):
    """Dynamic loss scaling with torch-GradScaler semantics (``trainer.py:89``):
    on non-finite grads the step is skipped and the scale halves; after
    ``growth_interval`` finite steps in a row it doubles (capped).
    Returns (init, update): ``init(device)`` gives {"scale": float32,
    "growth_count": int32} device scalars; ``update(state, grads_finite)``
    the next state, by JAX's nested ``where`` (no host read)."""

    def init(device="cpu") -> dict:
        return {"scale": torch.full((), init_scale, dtype=torch.float32, device=device),
                "growth_count": torch.zeros((), dtype=torch.int32, device=device)}

    def update(state: dict, grads_finite) -> dict:
        scale, count = state["scale"], state["growth_count"]
        if not isinstance(grads_finite, torch.Tensor):
            grads_finite = torch.full((), bool(grads_finite), device=scale.device)
        grown = count + 1 >= growth_interval
        new_scale = torch.where(grads_finite,
                                torch.where(grown, (scale * 2.0).clamp(max=max_scale), scale),
                                (scale * 0.5).clamp(min=min_scale))
        new_count = torch.where(grads_finite & ~grown, count + 1, 0).to(torch.int32)
        return {"scale": new_scale, "growth_count": new_count}

    return init, update


# ---------------------------------------------------------------------------
# loss & metrics


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smooth: float = 0.0) -> torch.Tensor:
    """Per-position cross entropy with torch label-smoothing semantics, fp32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    if label_smooth > 0.0:
        nll = (1.0 - label_smooth) * nll + label_smooth * -logp.mean(-1)
    return nll


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    Lm: torch.Tensor  # mean unsmoothed CE
    Lt: torch.Tensor  # tail (last-scale) CE; -1 under progressive training
    accm: torch.Tensor  # mean top-1 acc (%)
    acct: torch.Tensor  # tail top-1 acc (%)
    grad_norm: torch.Tensor
    lr: float  # the host schedule's value (the step uses it rounded to float32)
    wd: float
    scale: torch.Tensor  # dynamic loss scale of this step (1.0 unless dscale)
    per_scale_L: torch.Tensor  # (S,)
    per_scale_acc: torch.Tensor  # (S,)
    pred_hist: torch.Tensor  # (V,) argmax histogram -> z_voc_usage


@torch.no_grad()
def _metrics_from_logits(logits: torch.Tensor, gt_bl: torch.Tensor, var_cfg: VARConfig,
                         prog_si: int) -> dict:
    ed = logits.shape[1]
    pred = logits.argmax(-1)
    ce = cross_entropy(logits, gt_bl)
    hit = (pred == gt_bl).float()
    last_l = var_cfg.patch_nums[-1] ** 2
    minus1 = torch.full((), -1.0, device=logits.device)
    lt = ce[:, -last_l:].mean() if prog_si < 0 else minus1
    acct = hit[:, -last_l:].mean() * 100.0 if prog_si < 0 else minus1
    nan = torch.full((), float("nan"), device=logits.device)
    per_l = [ce[:, bg:e].mean() if e <= ed else nan for bg, e in var_cfg.begin_ends]
    per_a = [hit[:, bg:e].mean() * 100.0 if e <= ed else nan for bg, e in var_cfg.begin_ends]
    # counted with index_add_ of ones (exact in float32): on a GPU
    # torch.bincount reads its input's range back to the host
    flat = pred.reshape(-1)
    hist = torch.zeros(var_cfg.vocab_size, device=logits.device).index_add_(
        0, flat, torch.ones(flat.shape, device=logits.device))
    return dict(Lm=ce.mean(), Lt=lt, accm=hit.mean() * 100.0, acct=acct,
                per_scale_L=torch.stack(per_l), per_scale_acc=torch.stack(per_a), pred_hist=hist)


# ---------------------------------------------------------------------------
# train / eval steps


@dataclass
class TrainState:
    var: torch.nn.Module
    opt: ClippedAdamW
    step: int = 0  # optimizer steps taken, skipped ones included
    scaler: Optional[dict] = field(default=None)  # dynamic loss-scale state (dscale)

    def tensors(self) -> List[torch.Tensor]:
        """What a compiled step reads and updates in place: the VAR's
        parameters and buffers, Adam's moments and count, the scaler."""
        return [*self.var.parameters(), *self.var.buffers(), *self.opt.tensors(),
                *(self.scaler or {}).values()]


def capturable(mesh: Optional[pm.Mesh]) -> bool:
    """Whether a step under ``mesh`` can be one CUDA graph: not when it
    has a process group (a gloo collective cannot be captured)."""
    return mesh is None or (mesh.data_group is None and mesh.model_group is None)


@torch.no_grad()
def tokenize(vae: vae_mod.VQVAE, img: torch.Tensor, args: TrainArgs) -> List[torch.Tensor]:
    """Frozen tokenizer: image batch (B, H, W, 3) -> token pyramid. ``vae_bf16``
    runs the encoder in bf16 (the quantizer stays fp32); ``tokenize_chunk``
    encodes in batch chunks of that size (the same tokens, a smaller peak)."""
    if args.vae_bf16:
        img = img.to(torch.bfloat16)
    tc = int(args.tokenize_chunk or 0)
    if 0 < tc < img.shape[0] and img.shape[0] % tc == 0:
        parts = [vae_mod.img_to_idxBl(vae, chunk) for chunk in img.split(tc)]
        return [torch.cat(per_scale) for per_scale in zip(*parts)]
    return vae_mod.img_to_idxBl(vae, img)


def teacher_loss(var: var_mod.VAR, vae: vae_mod.VQVAE, args: TrainArgs,
                 idx_bl: List[torch.Tensor], label: torch.Tensor,
                 generator: Optional[torch.Generator], prog_si: int = -1,
                 prog_wp: Scalar = 1.0, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "paired", mesh: Optional[pm.Mesh] = None):
    """(loss, metrics) of one micro-batch from its tokens (``trainer.py:207-241``);
    under a mesh, of this data rank's rows."""
    var_cfg = var.cfg
    L = var_cfg.seq_len
    ed = L if prog_si < 0 else var_cfg.begin_ends[prog_si][1]
    bg = 0 if prog_si < 0 else var_cfg.begin_ends[prog_si][0]
    gt_bl = torch.cat(idx_bl, dim=1)[:, :ed]
    with torch.no_grad():
        x_in = q.idxBl_to_var_input(vae.quantize, vae.cfg, idx_bl)
    logits = var_mod.var_forward(var, label, x_in, generator=generator, train=True,
                                 prog_si=prog_si, dtype=dtype, remat=args.remat,
                                 attn_impl=attn_impl, mesh=mesh)
    ce = cross_entropy(logits, gt_bl, args.ls)  # (B, ed)
    lw = torch.full((ed,), 1.0 / L, device=ce.device)
    if prog_si >= 0:  # prog_wp: a number or a device scalar (a captured step's input)
        wp = prog_wp.clamp(0.0, 1.0) if isinstance(prog_wp, torch.Tensor) else \
            min(max(float(prog_wp), 0.0), 1.0)
        lw[bg:ed] *= wp
    loss = (ce * lw).sum(-1).mean()
    return loss, _metrics_from_logits(logits.detach(), gt_bl, var_cfg, prog_si)


def _mean_over_data(mesh: Optional[pm.Mesh], m: dict, loss: torch.Tensor):
    """The metrics and loss of the global batch from each data rank's:
    means averaged, the prediction histogram summed, in one all-reduce."""
    if mesh is None or mesh.data_group is None:
        return m, loss
    keys = ("Lm", "Lt", "accm", "acct")
    s = len(m["per_scale_L"])
    flat = pm.all_reduce_(torch.cat([torch.stack([m[k] for k in keys] + [loss]),
                                     m["per_scale_L"], m["per_scale_acc"], m["pred_hist"]]),
                          mesh.data_group)
    flat[:5 + 2 * s] /= mesh.dp
    out = dict(zip(keys, flat[:4]))
    out.update(per_scale_L=flat[5:5 + s], per_scale_acc=flat[5 + s:5 + 2 * s],
               pred_hist=flat[5 + 2 * s:])
    return out, flat[4]


def _host_scalars(values, dev: torch.device) -> torch.Tensor:
    """A float32 vector of host numbers on ``dev``, through pinned memory
    on the GPU: a step's changing scalars reach its static buffer without
    blocking the host."""
    t = torch.tensor(list(values), dtype=torch.float32, pin_memory=dev.type == "cuda")
    return t.to(dev, non_blocking=True)


def make_train_step(var_cfg: VARConfig, vae_cfg: VAEConfig, args: TrainArgs,
                    iters_per_ep: int, prog_si: int = -1, dtype: torch.dtype = torch.bfloat16,
                    attn_impl: str = "paired", mesh: Optional[pm.Mesh] = None, pool=None):
    """(init_state, step) (``trainer.py:175``). ``attn_impl``: the training
    attention, resolved already (``config.resolve_attn``).

    ``step(state, vae, imgs (ac, B, H, W, 3), labels (ac, B), generator, g_it,
    prog_wp) -> (state, StepMetrics)``: updates ``state.var`` and the
    optimizer state in place. It is compiled (``engine/compiled.py``,
    ``trainer.py:312``'s jit): on CUDA the first call of a shape runs the
    body eagerly, then captures it; later calls copy imgs, labels, the
    generator state and the host-computed lr, wd and prog_wp into static
    buffers and replay. ``prog_si`` is static: one graph per progressive
    stage. ``step.program`` is the :class:`Compiled` (``graphs``: its
    entries) and ``step.eager`` the same step through the body directly.
    ``mesh``: ``imgs`` and ``labels`` are this data rank's B rows, ``var``
    holds this model rank's shards, and every rank passes a generator in
    the same state (cond-drop and drop-path draw for the global batch);
    ``init_state`` gives every data rank data rank 0's parameters; a mesh
    with a process group runs the body eagerly (``step.program`` None).
    ``pool``: a ``torch.cuda.MemPool`` shared with other programs
    (``Compiled``'s)."""
    skip_nonfinite = args.fp16 == 1
    dynamic_scale = bool(args.dscale) and args.fp16 == 1
    scaler_init, scaler_update = make_grad_scaler()
    max_it = float(args.ep * iters_per_ep)
    wp_it = float(args.wp * iters_per_ep)

    def init_state(var: var_mod.VAR) -> TrainState:
        pm.broadcast_from_data_root(mesh, list(var.parameters()))
        dev = next(var.parameters()).device
        return TrainState(var, make_adamw(var, args.tclip, mesh),
                          scaler=scaler_init(dev) if dynamic_scale else None)

    def body(state: TrainState, vae, imgs, labels, hyper, generator=None):
        """One step over device inputs only: ``hyper`` is (lr, wd, prog_wp)."""
        lr, wd, prog_wp = hyper[0], hyper[1], hyper[2]
        ac = imgs.shape[0]
        scale = state.scaler["scale"].clone() if dynamic_scale else torch.ones_like(lr)
        state.opt.zero_grad()  # the capture's backward makes the gradients in its pool
        loss_acc = torch.zeros((), device=imgs.device)
        for i in range(ac):
            idx_bl = tokenize(vae, imgs[i], args)
            loss, m = teacher_loss(state.var, vae, args, idx_bl, labels[i], generator, prog_si,
                                   prog_wp, dtype, attn_impl, mesh)
            # loss scaled before backward (amp_sc.py:43)
            (loss * (scale / ac) if dynamic_scale else loss * (1.0 / ac)).backward()
            loss_acc += loss.detach() / ac
        if mesh is not None and mesh.data_group is not None:  # one flat all-reduce
            grads = state.opt.grads()
            flat = pm.all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh.data_group)
            for g, f in zip(grads, flat.div_(mesh.dp).split([g.numel() for g in grads])):
                g.copy_(f.view_as(g))
        if dynamic_scale:  # unscale (GradScaler.unscale_)
            torch._foreach_div_(state.opt.grads(), scale)
        gnorm, _ = state.opt.step(lr, wd, skip_nonfinite)
        if dynamic_scale:  # not skip-guarded: an overflow must halve the scale
            for k, v in scaler_update(state.scaler, torch.isfinite(gnorm)).items():
                state.scaler[k].copy_(v)
        # metrics of the last micro-batch, as the reference logs them
        m, loss_acc = _mean_over_data(mesh, m, loss_acc)
        return (loss_acc, m["Lm"], m["Lt"], m["accm"], m["acct"], gnorm, scale,
                m["per_scale_L"], m["per_scale_acc"], m["pred_hist"])

    program = Compiled(body, 2, None, random=True, train=True,
                       pool=pool) if capturable(mesh) else None

    def make_step(call):
        def step(state: TrainState, vae, imgs, labels, generator, g_it: int,
                 prog_wp: float = 1.0):
            lr = args.tlr * lr_factor(args.sche, g_it, wp_it, max_it, args.wp0, args.wpe)
            wd = wd_value(g_it, max_it, args.twd, args.twde)
            hyper = _host_scalars((lr, wd, prog_wp), imgs.device)
            (loss, lm, lt, accm, acct, gnorm, scale, per_l, per_a,
             hist) = call(state, vae, imgs, labels, hyper, generator=generator)
            state.step += 1
            return state, StepMetrics(loss=loss, Lm=lm, Lt=lt, accm=accm, acct=acct,
                                      grad_norm=gnorm, lr=lr, wd=wd, scale=scale,
                                      per_scale_L=per_l, per_scale_acc=per_a, pred_hist=hist)
        return step

    step = make_step(program if program is not None else body)
    step.eager = make_step(program.eager if program is not None else body)
    step.program = program
    return init_state, step


def pick_eval_attn(train_attn: str, seq_len: int) -> str:
    """Eval attention for a train impl (``trainer.py:315-325``): the paired
    kernel's eval beyond 1000 tokens (the 512px and 1024px presets) goes to
    the streaming kernel, whose memory does not grow with L x L; 256px keeps
    the dense path. Any other impl evaluates as it trains."""
    if train_attn == "paired":
        return "pallas" if seq_len > 1000 else "xla"
    return train_attn


def make_eval_step(var_cfg: VARConfig, vae_cfg: VAEConfig, dtype: torch.dtype = torch.bfloat16,
                   attn_impl: str = "paired", mesh: Optional[pm.Mesh] = None, pool=None):
    """Validation step (``trainer.py:328``): summed [L_mean, L_tail, acc_mean,
    acc_tail, n] over the rows where ``valid`` (B,) is nonzero. The caller
    picks ``attn_impl`` with :func:`pick_eval_attn`. A :class:`Compiled`
    program on the modules' device (``trainer.py:342``'s jit), one entry a
    batch shape: ``valid`` is an input, so a padded last batch replays the
    same graph. ``mesh`` with a process group: each data rank passes its
    rows, and the sums come back summed over the data group, on every rank,
    from the eager body. ``pool``: a ``torch.cuda.MemPool`` shared with
    other programs (``Compiled``'s)."""
    last_l = var_cfg.patch_nums[-1] ** 2

    @torch.no_grad()
    def step(var, vae, img, label, valid):
        idx_bl = vae_mod.img_to_idxBl(vae, img)
        gt = torch.cat(idx_bl, dim=1)
        x_in = q.idxBl_to_var_input(vae.quantize, vae_cfg, idx_bl)
        logits = var_mod.var_forward(var, label, x_in, train=False, dtype=dtype,
                                     attn_impl=attn_impl, mesh=mesh)
        v = valid.float()
        ce = cross_entropy(logits, gt)
        hit = (logits.argmax(-1) == gt).float()
        sums = torch.stack([
            (ce.mean(1) * v).sum(),
            (ce[:, -last_l:].mean(1) * v).sum(),
            (hit.mean(1) * 100.0 * v).sum(),
            (hit[:, -last_l:].mean(1) * 100.0 * v).sum(),
            v.sum(),
        ])
        return sums if mesh is None else pm.all_reduce_(sums, mesh.data_group)

    return Compiled(step, 2, None, pool=pool) if capturable(mesh) else step
