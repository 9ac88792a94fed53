"""Scale-by-scale CFG decoding (counterpart of ``var_tpu/engine/sampler.py``).

Reproduces ``VAR.autoregressive_infer_cfg`` (reference
``models/var.py:126-190``) and ``VAR.inpainting`` (``var.py:236-364``):

* the batch is doubled (cond | uncond, the unconditional class being
  ``num_classes``); the guidance weight ramps with scale,
  t = cfg * si / (S - 1), mixed before the fp32 head;
* per scale: the transformer stage over the current token map with the
  in-place KV cache, logits, top-k/top-p sampling through the bound kernel
  (or gumbel-softmax codebook mixing with ``more_smooth``), the quantizer's
  residual update, and the next scale's input through ``word_embed`` in
  float32, tiled x2;
* finally the VQVAE decoder renders f_hat.

The zero-shot branches: token-mask inpainting (``gt_tokens`` +
``keep_mask``), embedding-space box editing (``gt_tokens`` +
``edit_mask``), ``kv_window`` pruning, the ``cache_impl`` representations,
neighbour-constrained :func:`smooth_sampling` and the dispatch-batched
:func:`make_scan_sampler`. :func:`make_sampler` (plain, inpainting and
box editing) and :func:`make_smooth_sampler` are compiled: on CUDA each
replays one CUDA graph (``engine/compiled.py``), as the JAX package jits
them.

Public outputs keep the JAX layouts: image (B, H, W, 3) in [0, 1], tokens
(B, L), f_hat (B, h, w, Cvae).

``mesh`` (``parallel/mesh.py``, JAX ``sampler.py:99-121``, ``:408-411``):
every rank passes the whole batch; each data rank decodes its rows, each
model rank its heads of each block (the module sharded by
``mesh.shard_var_params``), and the results are gathered over the data
group, so every rank returns the whole batch. The model ranks of a data
rank hold the same gathered logits and draw from the same generator, so
they feed the same next input; a data rank's noise is its rows of the
global batch's draw, so the decode is the one-process decode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from var_tpu_torch.device import fp32_exact, resolve_device
from var_tpu_torch.engine.compiled import Compiled, CompiledEntry
from var_tpu_torch.models import quantizer as q
from var_tpu_torch.models import vae as vae_mod
from var_tpu_torch.models import var as var_mod
from var_tpu_torch.ops.resize import resize_bilinear
from var_tpu_torch.ops.sampling import gumbel_softmax, sample_with_top_k_top_p
from var_tpu_torch.parallel import shard_attn as sa
from var_tpu_torch.parallel.mesh import Mesh, capturable, data_rows, gather_data
from var_tpu_torch.utils.profiling import COUNTERS, span
from var_tpu_torch.utils.profiling import call as profiled_call

CACHE_IMPLS = ("chunked", "prealloc", "concat")


class DecodeResult(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) in [0, 1], float32
    tokens: torch.Tensor  # (B, L) int64 final ids (inpainting: kept positions hold gt)
    f_hat: torch.Tensor  # (B, h, w, Cvae) float32


def _check_branches(gt_tokens, keep_mask, edit_mask, kv_window, cache_impl) -> None:
    if (keep_mask is not None or edit_mask is not None) and gt_tokens is None:
        raise ValueError("keep_mask and edit_mask need gt_tokens")
    if kv_window is not None and kv_window < 1:
        raise ValueError(f"kv_window must be >= 1, got {kv_window}")
    if cache_impl not in CACHE_IMPLS:
        raise ValueError(f"cache_impl must be one of {CACHE_IMPLS}, got {cache_impl!r}")


def window_len(patch_nums: Sequence[int], kv_window: int) -> int:
    """The most cache rows a stage of a ``kv_window`` decode attends to:
    stage 0 (the ``first_l`` prefix) plus stages max(1, t - w + 1) .. t
    (the length ``var_tpu``'s ``window_chunks_viable`` computes)."""
    lens = [pn * pn for pn in patch_nums]
    return max(lens[0] + sum(lens[max(1, t - kv_window + 1):t + 1]) for t in range(len(lens)))


def _slide_window(cache: var_mod.KVCache, lens: Sequence[int], t: int, kv_window: int) -> None:
    """Before stage ``t``: drop stage t - kv_window (when it is >= 1) by
    moving the kept stages' rows down behind the prefix, so the window stays
    contiguous at rows [0, cum). Source and destination overlap, so the move
    goes front to back in chunks no longer than the shift. One copy per
    stage, over every layer, as the JAX concat path copies (``sampler.py:
    142-149``). The JAX package's VMEM-envelope machinery for windows
    (``paired_chunks_ok``, ``maybe_concat_chunks``, ``window_chunks_viable``,
    ``chunks_to_concat``, ``var.py:771-837``) has no counterpart: the
    kernel serves every window length."""
    drop = t - kv_window
    if drop < 1:
        return
    first_l, shift = lens[0], lens[drop]
    n = cache.cum - first_l - shift
    for buf in (cache.k, cache.v):
        for i in range(0, n, shift):
            m = min(shift, n - i)
            buf[:, :, first_l + i:first_l + i + m].copy_(
                buf[:, :, first_l + shift + i:first_l + shift + i + m])
    cache.cum -= shift


def _edit_blend(quant, gt_seg: torch.Tensor, edit_mask: torch.Tensor, h: torch.Tensor,
                pn: int) -> torch.Tensor:
    """Box editing (``sampler.py:165-176``): ground-truth embeddings where
    the (ph, pw) ``edit_mask``, bilinearly resized to pn x pn and thresholded
    at > 0.5 in float32, keeps them; all ground truth at scales of <= 3
    tokens."""
    gt_h = q.embed(quant, gt_seg).reshape(h.shape)
    if pn * pn <= 3:
        return gt_h
    m = resize_bilinear(edit_mask.float()[None, :, :, None], (pn, pn))
    force = (m > 0.5).float()
    return gt_h * force + h * (1.0 - force)


def _next_input(var: var_mod.VAR, nxt: torch.Tensor, lvl_pos: torch.Tensor, cur: int,
                b: int) -> torch.Tensor:
    """The next scale's token map from the quantizer-space input ``nxt``
    (B, pn, pn, Cvae): ``word_embed`` in float32 plus its positions, tiled
    x2 for the CFG batch (``var.py:187``)."""
    nseg = nxt.shape[1] * nxt.shape[2]
    ntm = var_mod._linear(var.word_embed, nxt.reshape(b, nseg, -1).float())
    return (ntm + lvl_pos[:, cur:cur + nseg]).repeat(2, 1, 1)


def _decode_cache(var_cfg, batch: int, dtype: torch.dtype, device, *args) -> var_mod.KVCache:
    """A decode's KV cache (``var.init_prealloc_caches``); the counter
    ``sampler.kv_bytes`` keeps the largest such K and V pair's bytes."""
    cache = var_mod.init_prealloc_caches(var_cfg, batch, dtype, device, *args)
    nbytes = 2 * cache.k.numel() * cache.k.element_size()
    COUNTERS["sampler.kv_bytes"] = max(COUNTERS["sampler.kv_bytes"], nbytes)
    return cache


def _start(var: var_mod.VAR, label_b: torch.Tensor, dtype: torch.dtype,
           mesh: Optional[Mesh] = None):
    """(cond_bd (2B, C), per-block context, lvl_pos (1, L, C), first token
    map (2B, first_l, C)) of a CFG decode."""
    cfg = var.cfg
    labels2 = torch.cat([label_b, torch.full_like(label_b, cfg.num_classes)])
    cond_bd = var.class_emb.weight[labels2]  # (2B, C) float32
    ctx = var_mod.cond_context(var, cond_bd, dtype, mesh)
    lvl_pos = var_mod.lvl_pos_embed(var)
    ntm = cond_bd[:, None, :] + var.pos_start + lvl_pos[:, :cfg.first_l]
    return cond_bd, ctx, lvl_pos, ntm


def decode_tokens_cfg(
    var: var_mod.VAR,
    vae: vae_mod.VQVAE,
    label_b: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    gt_tokens: Optional[torch.Tensor] = None,
    keep_mask: Optional[torch.Tensor] = None,
    edit_mask: Optional[torch.Tensor] = None,
    kv_window: Optional[int] = None,
    cache_impl: str = "chunked",
    mesh: Optional[Mesh] = None,
):
    """Transformer half of :func:`decode_cfg` -> (tokens (B, L), f_hat).
    Argument semantics are documented on :func:`decode_cfg`."""
    tokens, f_hat = _decode_rows(var, vae, label_b, generator, cfg_scale, top_k, top_p,
                                 more_smooth, dtype, gt_tokens, keep_mask, edit_mask, kv_window,
                                 cache_impl, mesh)
    return gather_data(mesh, tokens), gather_data(mesh, f_hat)


def _decode_rows(var, vae, label_b, generator, cfg_scale, top_k, top_p, more_smooth, dtype,
                 gt_tokens, keep_mask, edit_mask, kv_window, cache_impl, mesh):
    """This data rank's rows of :func:`decode_tokens_cfg`: (tokens, f_hat)."""
    _check_branches(gt_tokens, keep_mask, edit_mask, kv_window, cache_impl)
    var_cfg, vae_cfg = var.cfg, vae.cfg
    dp = sa.axis_sizes(mesh)[0]
    if label_b.shape[0] % dp:
        raise ValueError(f"a batch of {label_b.shape[0]} does not split over dp={dp}")
    b = label_b.shape[0] // dp
    row0, _ = rows = data_rows(mesh, b)
    label_b = label_b[row0:row0 + b]
    if gt_tokens is not None:
        gt_tokens = gt_tokens[row0:row0 + b]
    if keep_mask is not None:
        keep_mask = keep_mask[row0:row0 + b]
    pns = var_cfg.patch_nums
    lens = [pn * pn for pn in pns]
    sn = len(pns)
    quant = vae.quantize
    device = var.pos_1LC.device
    with span("start"):
        cond_bd, ctx, lvl_pos, ntm = _start(var, label_b, dtype, mesh)
        f_hat = torch.zeros(b, pns[-1], pns[-1], vae_cfg.z_channels, device=device)
        lmax = None if kv_window is None else window_len(pns, kv_window)
        paired = cache_impl != "chunked" or kv_window is not None
        cache = _decode_cache(var_cfg, 2 * b, dtype, device, lmax, paired, mesh)
    cur = 0
    token_segs = []
    for si, pn in enumerate(pns):
        ratio = si / var_cfg.num_stages_minus_1
        seg = lens[si]
        with span("transformer"):
            if kv_window is not None:
                _slide_window(cache, lens, si, kv_window)
            x, cache = var_mod.transformer_stage(var, ntm, ctx, cache, dtype, mesh)
        with span("head"):
            lg = var_mod.get_logits_cfg(var, x, cond_bd, cfg_scale * ratio, mesh)
        with span("filter"):
            idx = sample_with_top_k_top_p(lg, top_k=top_k, top_p=top_p, generator=generator,
                                          rows=rows)
            if keep_mask is not None:  # kept positions take the ground-truth ids
                idx = torch.where(keep_mask[:, cur:cur + seg], gt_tokens[:, cur:cur + seg], idx)
            token_segs.append(idx)
            if more_smooth:  # gumbel-softmax codebook mixing (var.py:178-180)
                gum_t = max(0.27 * (1 - ratio * 0.95), 0.005)
                soft = gumbel_softmax(lg * (1.0 + ratio), tau=gum_t, generator=generator,
                                      rows=rows)
                h = soft @ quant.embedding.weight.float()
            else:
                h = q.embed(quant, idx)
            h = h.reshape(b, pn, pn, vae_cfg.z_channels)
            if edit_mask is not None:
                h = _edit_blend(quant, gt_tokens[:, cur:cur + seg], edit_mask, h, pn)
        with span("next_input"):
            f_hat, nxt = q.get_next_autoregressive_input(quant, vae_cfg, si, f_hat, h, pns)
            cur += seg
            if si != sn - 1:
                ntm = _next_input(var, nxt, lvl_pos, cur, b)
    return torch.cat(token_segs, dim=1), f_hat


def render_fhat(vae: vae_mod.VQVAE, f_hat: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """VQVAE render half: f_hat -> images in [0, 1]; the decoder runs in the
    compute dtype (the reference decodes under fp16 autocast)."""
    img = vae_mod.fhat_to_img(vae, f_hat.to(dtype)).float()
    return img * 0.5 + 0.5


def decode_cfg(
    var: var_mod.VAR,
    vae: vae_mod.VQVAE,
    label_b: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    gt_tokens: Optional[torch.Tensor] = None,
    keep_mask: Optional[torch.Tensor] = None,
    edit_mask: Optional[torch.Tensor] = None,
    kv_window: Optional[int] = None,
    cache_impl: str = "chunked",
    approx_topk: bool = False,
    mesh: Optional[Mesh] = None,
) -> DecodeResult:
    """Class-conditional CFG decode of ``label_b`` (B,) int -> DecodeResult.

    With ``gt_tokens`` (B, L) int + ``keep_mask`` (B, L) bool (True = keep)
    it is token-mask inpainting: kept positions take the ground-truth ids
    before the embed and steer every later scale through the shared f_hat
    (``var.py:312-328``). With ``gt_tokens`` + ``edit_mask`` (ph, pw) float
    (1 = keep) it is box editing: per scale the mask is bilinearly resized,
    thresholded at 0.5, and blends ground-truth and generated codebook
    embeddings; scales of <= 3 tokens are all ground truth.

    ``kv_window`` (default off, the exact reference semantics): stage t
    attends to stage 0 plus stages max(1, t - kv_window + 1) .. t.
    ``cache_impl``: ``"chunked"`` attends through ``flash_decode`` (q norm
    in the kernel), ``"prealloc"``/``"concat"`` and every ``kv_window``
    decode through ``flash_decode_paired`` (scale folded into q), all over
    one in-place buffer (see ``models/var.py``). ``approx_topk`` is
    accepted for the JAX package's signature and discarded: the decode is
    exact (``ops/sampling.py::sample_with_top_k_top_p`` says why).
    ``mesh``: see the module docstring; each data rank renders its rows."""
    del approx_topk
    tokens, f_hat = _decode_rows(var, vae, label_b, generator, cfg_scale, top_k, top_p,
                                 more_smooth, dtype, gt_tokens, keep_mask, edit_mask, kv_window,
                                 cache_impl, mesh)
    with span("render"):
        img = render_fhat(vae, f_hat, dtype)
    return DecodeResult(*(gather_data(mesh, t) for t in (img, tokens, f_hat)))


class GraphDecode(CompiledEntry):
    """One capture-ready CFG decode of a batch size, plain, inpainting or
    box editing: a :class:`~var_tpu_torch.engine.compiled.CompiledEntry`
    whose modules are (``var``, ``vae``) and whose static inputs are the
    labels (and ``gt`` and the keep or edit mask)."""

    var = property(lambda self: self.modules[0])
    vae = property(lambda self: self.modules[1])


def make_sampler(
    var_cfg,
    vae_cfg,
    cfg_scale: float = 1.5,
    top_k: int = 0,
    top_p: float = 0.0,
    more_smooth: bool = False,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    inpainting: bool = False,
    kv_window: Optional[int] = None,
    cache_impl: str = "chunked",
    approx_topk: bool = False,
    mesh: Optional[Mesh] = None,
    editing: bool = False,
):
    """Compiled sampler ``(var, vae, generator, label_b) -> DecodeResult`` on
    ``device`` (``"cuda"`` unless the caller passes ``"cpu"``; raises when
    CUDA is asked for and absent); with ``inpainting`` it is ``(var, vae,
    generator, label_b, gt, mask)``, ``gt`` (B, L) ids and ``mask`` (B, L)
    bool keep mask; with ``editing`` the same with ``mask`` the (ph, pw)
    float edit mask of :func:`decode_cfg`'s box editing. Sampling
    hyper-parameters are fixed here, as the JAX sampler fixes them at
    compile time.

    On CUDA the whole decode (ten stages, sampling, the f_hat updates and
    the render) is one CUDA graph (``engine/compiled.py``), the counterpart
    of JAX's one jitted program (``sampler.py:247``): the first call at a
    batch size warms up eagerly (its result is that run's) and captures;
    later calls copy their inputs into static buffers and replay, so one
    capture serves every image of a box or a mask. From the same generator
    state a replay draws what the eager :func:`decode_cfg` draws and leaves
    the generator where it would. ``sampler.graphs`` holds the
    :class:`GraphDecode` of each (batch, inpainting), or of each (batch,
    edit mask shape) with ``editing``. On the CPU the same capture-ready
    body runs eagerly. Under a ``mesh`` of NCCL groups the decode is one
    graph too, the gathers over the data and model groups among its nodes;
    under a gloo mesh it runs eagerly (``parallel/mesh.py::capturable``).
    ``approx_topk`` and ``mesh``: as :func:`decode_cfg`'s.

    Tracing (``utils/profiling.py``): the decode marks its layers (``start``;
    per stage ``transformer``, ``head``, ``filter``, ``next_input``; then
    ``render``), device spans of each replay, 4 stamps a stage and 4 more,
    and inside each ``transformer`` one ``attention`` span a block around
    the cached-attention launch, on 2 stamps of its own (2 x depth stamps a
    stage more: 4 x 10 + 4 + 2 x 36 x 10 = 764 a d36 decode); a
    call is the host span ``sampler.call`` (``sampler.inputs``, the
    program's load and replay, ``sampler.outputs``) and, when it replayed,
    counts in ``sampler.calls`` and ``sampler.host_s``."""
    del approx_topk
    if inpainting and editing:
        raise ValueError("sampler: inpainting and editing are two samplers")
    dev = resolve_device(device)
    _check_branches(None, None, None, kv_window, cache_impl)
    kw = dict(cfg_scale=cfg_scale, top_k=top_k, top_p=top_p, more_smooth=more_smooth,
              dtype=dtype, kv_window=kv_window, cache_impl=cache_impl, mesh=mesh)
    conditioned = inpainting or editing

    def sample(var, vae, labels, gt, mask, *, generator) -> DecodeResult:
        masks = {"edit_mask": mask} if editing else {"keep_mask": mask}
        return decode_cfg(var, vae, labels, generator, gt_tokens=gt, **masks, **kw)

    def slot(labels, gt, mask) -> tuple:
        return (labels.shape[0], tuple(mask.shape)) if editing else (labels.shape[0], inpainting)

    program = Compiled(sample, 2, dev, random=True, slot=slot, entry_cls=GraphDecode)
    call = program.static if capturable(mesh) else program.eager

    def decode(var, vae, generator, label_b, gt=None, mask=None) -> DecodeResult:
        """The decode into a :class:`GraphDecode`'s static outputs (valid
        until the next call); see :class:`~var_tpu_torch.engine.compiled.
        Compiled` for when an entry captures anew."""
        if var.cfg != var_cfg or vae.cfg != vae_cfg:
            raise ValueError("sampler: the modules' configs differ from the sampler's")
        if conditioned != (gt is not None and mask is not None):
            raise ValueError("sampler: gt and mask go together, with inpainting=True or "
                             "editing=True only")
        with span("sampler.inputs"):
            labels = torch.as_tensor(label_b, dtype=torch.int64, device=dev)
            if conditioned:
                gt = torch.as_tensor(gt, dtype=torch.int64, device=dev)
                mask = torch.as_tensor(mask, dtype=torch.float32 if editing else torch.bool,
                                       device=dev)
        return call(var, vae, labels, gt, mask, generator=generator)

    def sampler(var, vae, generator, label_b, gt=None, mask=None) -> DecodeResult:
        with profiled_call("sampler.call", "sampler.calls", "sampler.host_s"), \
                torch.inference_mode():
            res = decode(var, vae, generator, label_b, gt, mask)
            with span("sampler.outputs"):
                return DecodeResult(*(t.clone() for t in res))

    sampler.graphs, sampler.static_decode = program.graphs, decode
    return sampler


def fold_in(generator: torch.Generator, r: int) -> torch.Generator:
    """A new generator on ``generator``'s device, seeded from its initial
    seed and ``r`` (numpy's ``SeedSequence([seed, r])``): the port's
    counterpart of ``jax.random.fold_in``. It reads only the initial seed,
    so it shares no state with ``generator`` and does not advance it."""
    seed = int(np.random.SeedSequence([generator.initial_seed(), int(r)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=generator.device).manual_seed(seed)


def make_scan_sampler(var_cfg, vae_cfg, rounds: int, device="cuda",
                      mesh: Optional[Mesh] = None, **sampler_kw):
    """Dispatch-batched sampler ``(var, vae, generator, labels (rounds, B))
    -> DecodeResult`` with leading (rounds, B, ...) axes: ``rounds``
    independent decodes, stacked. Round r equals :func:`make_sampler`
    called with ``fold_in(generator, r)``. On CUDA the rounds are replays
    of :func:`make_sampler`'s captured decode, issued back to back into the
    stacked outputs with no host synchronisation between them: the port's
    counterpart of the JAX package's one-program ``lax.scan``
    (``sampler.py:300``). Under a ``mesh`` each round is split as
    :func:`decode_cfg` splits it, and replays under NCCL groups; on the
    CPU, and under a gloo mesh, the rounds run eagerly."""
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    sampler = make_sampler(var_cfg, vae_cfg, device=device, mesh=mesh, **sampler_kw)
    dev = resolve_device(device)

    def run(var, vae, generator, labels_rb) -> DecodeResult:
        with torch.inference_mode():
            labels_rb = torch.as_tensor(labels_rb, dtype=torch.int64, device=dev)
            out = None
            for r in range(rounds):
                res = sampler.static_decode(var, vae, fold_in(generator, r), labels_rb[r])
                if out is None:
                    out = DecodeResult(*(t.new_empty((rounds, *t.shape)) for t in res))
                for dst, src in zip(out, res):
                    dst[r].copy_(src)
            return out

    run.graphs = sampler.graphs
    return run


# ---------------------------------------------------------------------------
# neighbour-constrained "smooth sampling" (reference var.py:366-575)


class SmoothResult(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) in [0, 1]
    tokens: torch.Tensor  # (B, L) selected token ids
    log_likelihood: torch.Tensor  # scalar: sum of selected model log-probs
    distance_log_likelihood: torch.Tensor  # scalar: sum of distance log-probs


def codebook_neighbor_tables(embedding: torch.Tensor, n: int):
    """(dists (V, V) L2, the n nearest ids (V, n), their dists (V, n)),
    computed as |e_i|^2 + |e_j|^2 - 2 e_i e_j in float32 with TF32 off.
    Ties in distance keep the lower id first, as ``jax.lax.top_k`` does
    (a stable sort; ``torch.topk`` does not promise an order)."""
    emb = embedding.float()
    sq = (emb * emb).sum(1)
    with fp32_exact():
        d2 = sq[:, None] + sq[None, :] - 2.0 * (emb @ emb.T)
    dists = torch.sqrt(d2.clamp(min=0.0))
    top_d, top_i = torch.sort(dists, dim=1, stable=True)
    return dists, top_i[:, :n], top_d[:, :n]


def smooth_sampling(
    var: var_mod.VAR,
    vae: vae_mod.VQVAE,
    gt_tokens: torch.Tensor,
    n: int,
    label_b: torch.Tensor,
    cfg_scale: float = 1.5,
    neighbor_threshold: Optional[float] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> SmoothResult:
    """Regenerate an image constrained to codebook-space neighbours of the
    ground-truth tokens ``gt_tokens`` (B, L) (reference
    ``VAR.smooth_sampling``).

    Candidate-count mode (``neighbor_threshold`` None): at scale ratio r the
    candidates are the 1 + int((n - 1) r) nearest neighbours of each GT
    token; pick the one the model gives the most log-probability
    (``var.py:498-502``). Threshold mode: the candidates within
    d_min + (thr - d_min) r; a position whose candidates are all masked
    falls back to its nearest neighbour (``var.py:504-527``). The decode
    attends through the chunked cache; the render runs in float32."""
    var_cfg, vae_cfg = var.cfg, vae.cfg
    b = gt_tokens.shape[0]
    pns = var_cfg.patch_nums
    sn = len(pns)
    quant = vae.quantize
    device = var.pos_1LC.device
    with torch.inference_mode():
        _, top_n, top_n_dists = codebook_neighbor_tables(quant.embedding.weight, n)
        cond_bd, ctx, lvl_pos, ntm = _start(var, label_b, dtype)
        f_hat = torch.zeros(b, pns[-1], pns[-1], vae_cfg.z_channels, device=device)
        cache = _decode_cache(var_cfg, 2 * b, dtype, device)
        cur = 0
        sum_ll = torch.zeros((), device=device)
        sum_dll = torch.zeros((), device=device)
        token_segs = []
        ar = torch.arange(n, device=device)
        for si, pn in enumerate(pns):
            ratio = si / var_cfg.num_stages_minus_1
            seg = pn * pn
            x, cache = var_mod.transformer_stage(var, ntm, ctx, cache, dtype)
            lg = var_mod.get_logits_cfg(var, x, cond_bd, cfg_scale * ratio)
            log_probs = torch.log_softmax(lg, dim=-1)  # (B, seg, V)

            gt_seg = gt_tokens[:, cur:cur + seg]
            cand = top_n[gt_seg]  # (B, seg, n)
            cand_dists = top_n_dists[gt_seg]
            dist_logp = torch.log_softmax(-cand_dists, dim=-1)
            cand_logp = torch.gather(log_probs, -1, cand)
            if neighbor_threshold is None:
                keep = ar < 1 + int((n - 1) * ratio)
            else:
                d_min = cand_dists[:, :, :1]
                keep = cand_dists <= d_min + (neighbor_threshold - d_min) * ratio
            masked = cand_logp.masked_fill(~keep, float("-inf"))
            max_val, max_idx = masked.max(dim=-1)  # first maximum, as jnp.argmax
            # nearest neighbour where every candidate is masked (var.py:521-527)
            all_masked = ~torch.isfinite(max_val)
            max_idx = max_idx.masked_fill(all_masked, 0)
            max_val = torch.where(all_masked, cand_logp[..., 0], max_val)

            tokens = torch.gather(cand, -1, max_idx[..., None])[..., 0]
            token_segs.append(tokens)
            sum_ll = sum_ll + max_val.sum()
            sum_dll = sum_dll + torch.gather(dist_logp, -1, max_idx[..., None]).sum()

            h = q.embed(quant, tokens).reshape(b, pn, pn, vae_cfg.z_channels)
            f_hat, nxt = q.get_next_autoregressive_input(quant, vae_cfg, si, f_hat, h, pns)
            cur += seg
            if si != sn - 1:
                ntm = _next_input(var, nxt, lvl_pos, cur, b)
        img = vae_mod.fhat_to_img(vae, f_hat) * 0.5 + 0.5
    return SmoothResult(img, torch.cat(token_segs, dim=1), sum_ll, sum_dll)


def make_smooth_sampler(n: int, cfg_scale: float = 1.5,
                        neighbor_threshold: Optional[float] = None,
                        dtype: torch.dtype = torch.bfloat16, device="cuda") -> Compiled:
    """Compiled :func:`smooth_sampling` ``(var, vae, gt_tokens, label_b) ->
    SmoothResult`` on ``device``, with ``n``, the scale, the threshold and
    the dtype fixed, as ``var_tpu/apps/smooth.py:57`` jits it. On CUDA one
    CUDA graph a batch size replays the whole decode, the neighbour tables
    (recomputed in each run, as JAX's program recomputes them) and the
    render; the log-likelihood sums come back as 0-d static outputs."""

    def run(var, vae, gt_tokens, label_b) -> SmoothResult:
        return smooth_sampling(var, vae, gt_tokens, n, label_b, cfg_scale, neighbor_threshold,
                               dtype)

    return Compiled(run, 2, device)
