"""FabricNet — the flagship training workload of the fabric, on one card;
the counterpart of ``incubator_brpc_tpu/models/fabricnet.py``.

The JAX package ``shard_map``s one training step over the five fabric axes
(dp/ep data fan-out and gradient merge, a tp Megatron MLP, a pp GPipe ring,
the sp sequence ring, an ep expert exchange). This slice runs it on the
one-device mesh, where every axis is 1:

- ``psum``, ``pmean``, ``all_to_all`` and ``ppermute`` are identities;
- the GPipe ``_pipeline`` is a loop over the microbatches;
- the sp block is ring attention with ``sp = 1`` (one K3 forward launch per
  microbatch and its K3 backward), or, with ``heads = 0``, the ring mean,
  which on one rank is the mean over the sequence (K4f, with the last MLP
  layer's residual add, forward and backward);
- the MoE routes token ``r`` to local expert ``r % e_local``, exactly as
  ``_moe`` does (``reshape(t // e_local, e_local, d).swapaxes(0, 1)``).

Parameters are a plain dict with JAX's names and shapes, each with the
leading ``pp`` dimension: ``w_in``, ``w_out``, ``moe_w1``, ``moe_w2``,
``gate``, ``head``, and with heads ``wqkv`` and ``wo``. The einsums go to
``torch.matmul`` (cuBLAS on the card), as the JAX package left them to XLA.
Each residual add and the RMS norm that reads its sum, and each GeLU, are
K4 (``ops/elementwise.py``: hand-written kernels on the card, forward and
backward). So is the rest of what XLA fuses around the matrix products
(K4e): the MoE's gate and combine with the last residual add
(``moe_combine``, forward and backward), the loss with its gradient
(``mse_loss_fwd``), and the SGD update over every leaf in one launch
(``ops/update.py`` ``sgd_update_multi``), which rounds as JAX does: the
learning rate in the parameters' dtype, and in float32 one fused
multiply-add.

The train step updates the parameters **in place** and returns the same
dict with the loss. Its autograd leaves are the finest slices the forward
reads (one a layer of ``w_in`` and ``w_out``, one a projection of
``wqkv``; ``_weights``), so the backward forms no gradient of a whole
parameter, as the reference's donated ``jax.jit`` step forms none; the
backward starts from K4e-d's gradient of the output. Schedules:

- ``"fused"``: one forward and backward over the batch (its ``microbatches``
  the pipeline's), then the update;
- ``"serialized"`` and ``"overlapped"``: the batch cut into ``microbatches``
  contiguous row slices, each a forward and backward of its own with one
  inner microbatch; the gradients accumulate per leaf in the parameters'
  dtype (``acc = g_0``, then ``acc + g_m``), the loss in float32, and the
  parameters take one scaled update after the last slice, returning
  ``loss_acc / M`` in float32. Across ranks the two differ in whether slice
  m's gradient reductions are pinned before slice m + 1's forward; on one
  card there is no reduction and no barrier, so both run the same ops and
  give byte-identical losses and parameters, as the reference's do.

FabricNet on a mesh with an axis above 1 is a later slice (ROADMAP slice 4).

Entry points run on the card unless the mesh (or ``device``) says ``cpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from incubator_brpc_tpu_torch.models.ring_attention import ring_attention
from incubator_brpc_tpu_torch.ops.elementwise import (
    add_rms_norm, gelu, moe_combine, mse_loss_fwd, ring_mean_add)
from incubator_brpc_tpu_torch.ops.update import sgd_update_multi
from incubator_brpc_tpu_torch.parallel.mesh import FABRIC_AXES, FabricMesh, make_fabric_mesh
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

SCHEDULES = ("fused", "serialized", "overlapped")
Params = Dict[str, torch.Tensor]
# the forward's view of the parameters (_weights): a tensor, or a list of them
Weights = Dict[str, Union[torch.Tensor, List[torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class FabricNetConfig:
    d_model: int = 32
    d_ff: int = 64
    d_expert: int = 32
    experts_per_rank: int = 2
    layers_per_stage: int = 1
    batch: int = 8
    seq: int = 16
    microbatches: int = 2
    heads: int = 2  # ring-attention heads; 0 = ring-mean context instead
    lr: float = 1e-2
    dtype: torch.dtype = torch.float32


def param_shapes(cfg: FabricNetConfig, mesh: FabricMesh) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """Name -> (shape, init scale), in the JAX package's order."""
    pp, ep = mesh.shape["pp"], mesh.shape["ep"]
    d, f, fe = cfg.d_model, cfg.d_ff, cfg.d_expert
    L = cfg.layers_per_stage
    E = cfg.experts_per_rank * ep
    shapes = {
        "w_in": ((pp, L, d, f), 1.0 / np.sqrt(d)),
        "w_out": ((pp, L, f, d), 1.0 / np.sqrt(f)),
        "moe_w1": ((pp, E, d, fe), 1.0 / np.sqrt(d)),
        "moe_w2": ((pp, E, fe, d), 1.0 / np.sqrt(fe)),
        "gate": ((pp, d, 1), 1.0 / np.sqrt(d)),
        "head": ((d, d), 1.0 / np.sqrt(d)),
    }
    if cfg.heads:
        shapes["wqkv"] = ((pp, 3, d, d), 1.0 / np.sqrt(d))
        shapes["wo"] = ((pp, d, d), 1.0 / np.sqrt(d))
    return shapes


def init_params(
    cfg: FabricNetConfig,
    mesh: FabricMesh,
    generator: Optional[torch.Generator] = None,
    seed: int = 0,
) -> Params:
    """Normal weights times ``1/sqrt(fan_in)``, multiplied in the config's
    dtype, made on the mesh's device from ``generator`` (or ``seed``). The
    numbers are not the JAX package's: parity tests carry its weights
    across with :func:`params_from_numpy`."""
    if generator is None:
        generator = torch.Generator(device=mesh.device)
        generator.manual_seed(seed)
    out = {}
    for name, (shape, scale) in param_shapes(cfg, mesh).items():
        w = torch.randn(shape, generator=generator, dtype=cfg.dtype, device=mesh.device)
        out[name] = w * torch.tensor(scale, dtype=cfg.dtype, device=mesh.device)
    return out


def params_from_numpy(
    arrays: Mapping[str, np.ndarray], cfg: FabricNetConfig, device: DeviceLike = None
) -> Params:
    """The JAX parameter dict as numpy arrays (``np.asarray(jax_array)``) ->
    the port's parameters in the config's dtype. numpy has no bfloat16, so
    values pass through float32, which holds every bfloat16 exactly."""
    dev = resolve_device(device)
    want = ("w_in", "w_out", "moe_w1", "moe_w2", "gate", "head") + (
        ("wqkv", "wo") if cfg.heads else ()
    )
    if set(arrays) != set(want):
        raise ValueError(f"parameter names {sorted(arrays)}; want {sorted(want)}")
    return {
        name: torch.from_numpy(np.asarray(arrays[name], dtype=np.float32).copy()).to(
            device=dev, dtype=cfg.dtype
        )
        for name in want
    }


# -- the model -------------------------------------------------------------------


def _mlp(w_in_l, w_out_l, x):
    """The Megatron MLP of ``_mlp_tp``; with tp = 1 the ``psum`` is the identity."""
    return gelu(x @ w_in_l) @ w_out_l


def _moe(moe_w1, moe_w2, gate_w, x, s):
    """Static round-robin MoE with ep = 1, added to the residual stream
    ``s``: the ``all_to_all``s are identities and token ``r`` goes to local
    expert ``r % e_local``; K4e-b reads the experts' output in that layout."""
    e_local = moe_w1.shape[0]
    mb, sl, d = x.shape
    t = mb * sl
    tokens = x.reshape(t, d)
    logit = tokens @ gate_w  # (t, 1); its sigmoid is K4e-b's
    xr = tokens.reshape(t // e_local, e_local, d).transpose(0, 1)  # (e_local, t/e_local, d)
    h = gelu(torch.bmm(xr, moe_w1))
    yr = torch.bmm(h, moe_w2)
    return moe_combine(s.reshape(t, d), yr, logit).reshape(mb, sl, d)


def _ring_attn_block(wqkv, wo, heads: int, x):
    """Causal ring attention (sp = 1) with the stage's projections."""
    mb, sl, d = x.shape
    q, k, v = ((x @ wqkv[j]).reshape(mb, sl, heads, d // heads) for j in range(3))
    out = ring_attention(q, k, v, sp=1, causal=True)
    return out.reshape(mb, sl, d) @ wo


def _stage_fn(w: Weights, heads: int, x):
    """One pipeline stage: L residual MLP layers, the sequence block (ring
    attention, or the ring mean when heads = 0), and the MoE block. Each
    residual add goes with the norm that reads its sum (``add_rms_norm``:
    one K4a forward, one K4b backward that also takes the sum's own
    gradient). The last add is K4e-b's, with the MoE's gate. With heads =
    0 the last MLP layer's add goes with the ring mean, ``x +
    _ring_context(x)`` (K4f, which writes only that sum), and the MoE's
    norm reads the sum with no delta, its K4b still taking the sum's own
    gradient."""
    s, delta = x, None
    for l in range(len(w["w_in"])):
        s, n = add_rms_norm(s, delta)
        delta = _mlp(w["w_in"][l], w["w_out"][l], n)
    if heads:
        s, n = add_rms_norm(s, delta)
        s, n = add_rms_norm(s, _ring_attn_block(w["wqkv"], w["wo"], heads, n))
    else:
        s, n = add_rms_norm(ring_mean_add(s, delta))
    return _moe(w["moe_w1"], w["moe_w2"], w["gate"], n, s)


def _weights(params: Params, heads: int) -> Weights:
    """The weights as the forward of the one rank reads them, each the
    finest slice it uses: views of ``params`` (stage 0 of ``pp = 1``), one
    a layer for ``w_in`` and ``w_out``, one a projection for ``wqkv``, and
    ``head`` whole. The train step makes each view an autograd leaf, so no
    gradient of a whole parameter is ever formed."""
    w: Weights = {k: params[k][0] for k in ("moe_w1", "moe_w2", "gate")}
    w["w_in"], w["w_out"] = list(params["w_in"][0]), list(params["w_out"][0])
    if heads:
        w["wqkv"], w["wo"] = list(params["wqkv"][0]), params["wo"][0]
    w["head"] = params["head"]
    return w


def _leaves(w: Weights):
    """The tensors of ``w``, in a fixed order."""
    for v in w.values():
        yield from v if isinstance(v, list) else (v,)


def _local_forward(cfg: FabricNetConfig, w: Weights, x: torch.Tensor,
                   microbatches: int = 0) -> torch.Tensor:
    """The forward of the one rank: contiguous row microbatches
    (``x.reshape(m, bl // m, sl, d)``) through the stage in order (GPipe
    with pp = 1), then the head. ``microbatches`` overrides the config's
    (a sliced schedule's slice runs one)."""
    bl, sl, d = x.shape
    m = microbatches or cfg.microbatches
    xs = x.reshape(m, bl // m, sl, d)
    outs = torch.stack([_stage_fn(w, cfg.heads, xs[i]) for i in range(m)])
    return outs.reshape(bl, sl, d) @ w["head"]


def _local_loss(cfg: FabricNetConfig, w: Weights, x, y, microbatches: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, out, d_out)``: the output (differentiable), ``mean((out -
    y)^2)`` summed in float32 and rounded to the model's dtype as
    ``jnp.mean`` does (the ``pmean`` over size-1 axes is the identity), and
    the loss's gradient with respect to ``out`` (K4e-d)."""
    out = _local_forward(cfg, w, x, microbatches)
    loss, d_out = mse_loss_fwd(out.detach(), y)
    return loss, out, d_out


def _grads(cfg: FabricNetConfig, views: Weights, x, y, microbatches: int = 0):
    """``(loss, grads)``: the loss and its gradient for each leaf of
    ``views`` in ``_leaves`` order, each view a fresh autograd leaf."""
    leaves = {k: [t.detach().requires_grad_() for t in v] if isinstance(v, list)
              else v.detach().requires_grad_() for k, v in views.items()}
    with torch.enable_grad():
        loss, out, d_out = _local_loss(cfg, leaves, x, y, microbatches)
        return loss, torch.autograd.grad(out, list(_leaves(leaves)), d_out)


# -- entry points ----------------------------------------------------------------


def _mesh(mesh: Optional[FabricMesh], device: DeviceLike) -> FabricMesh:
    if mesh is None:
        return make_fabric_mesh(1, device=device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh


def validate_config(cfg: FabricNetConfig, mesh: FabricMesh) -> None:
    """The one-card mesh and the divisibility the shapes need."""
    for ax in FABRIC_AXES:
        if mesh.shape[ax] > 1:
            raise ValueError(
                f"mesh axis {ax}={mesh.shape[ax]}: FabricNet runs on one card here; "
                "a mesh with an axis above 1 is ROADMAP slice 4"
            )
    if cfg.batch % cfg.microbatches:
        raise ValueError("batch must divide by microbatches")
    if cfg.heads and cfg.d_model % cfg.heads:
        raise ValueError("d_model must divide by heads")
    t = (cfg.batch // cfg.microbatches) * cfg.seq
    if t % cfg.experts_per_rank:
        raise ValueError("tokens per microbatch must divide by experts_per_rank")


def make_forward_step(
    cfg: FabricNetConfig, mesh: Optional[FabricMesh] = None, device: DeviceLike = None
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``(params, x) -> (B, S, d)`` output, without gradients."""
    mesh = _mesh(mesh, device)
    validate_config(cfg, mesh)

    @torch.no_grad()
    def fwd(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _local_forward(cfg, _weights(params, cfg.heads), x)

    return fwd


def make_train_step(
    cfg: FabricNetConfig,
    mesh: Optional[FabricMesh] = None,
    schedule: str = "fused",
    device: DeviceLike = None,
) -> Callable[[Params, torch.Tensor, torch.Tensor], Tuple[Params, torch.Tensor]]:
    """The full training step (forward, backward, SGD): ``(params, x, y) ->
    (params, loss)``, the parameters updated in place. ``"fused"`` returns
    the loss in the model's dtype; ``"serialized"`` and ``"overlapped"``
    (identical on one card, see the module's docstring) return the slices'
    mean loss in float32."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    mesh = _mesh(mesh, device)
    validate_config(cfg, mesh)

    # the fused step is one slice of cfg.microbatches; a sliced step is
    # cfg.microbatches slices of one
    sliced = schedule != "fused"
    m, inner = (cfg.microbatches, 1) if sliced else (1, cfg.microbatches)

    @torch.no_grad()
    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        views = _weights(params, cfg.heads)
        xs, ys = (t.reshape(m, t.shape[0] // m, *t.shape[1:]) for t in (x, y))
        acc = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device) if sliced else None
        for i in range(m):
            loss, grads = _grads(cfg, views, xs[i], ys[i], microbatches=inner)
            if sliced:
                loss_acc = loss_acc + loss.float()
            if i == m - 1:  # one update, after the last slice
                sgd_update_multi("fused" if acc is None else "last", list(_leaves(views)),
                                 grads, cfg.lr, acc=acc, slices=m)
            elif acc is None:
                acc = [g.contiguous() for g in grads]
            else:
                sgd_update_multi("accumulate", acc, grads)
        return params, loss_acc * (1.0 / m) if sliced else loss

    return step


def make_batch(
    cfg: FabricNetConfig,
    mesh: FabricMesh,
    generator: Optional[torch.Generator] = None,
    seed: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random ``(x, y)`` of shape ``(batch, seq, d_model)`` on the mesh's device."""
    if generator is None:
        generator = torch.Generator(device=mesh.device)
        generator.manual_seed(seed)
    shape = (cfg.batch, cfg.seq, cfg.d_model)
    x = torch.randn(shape, generator=generator, dtype=cfg.dtype, device=mesh.device)
    y = torch.randn(shape, generator=generator, dtype=cfg.dtype, device=mesh.device)
    return x, y


def forward_flops(cfg: FabricNetConfig) -> Dict[str, int]:
    """FLOPs (2 per multiply-add) of one forward over the whole batch, from
    the shapes: the matrix products, and attention's two products over every
    (query, key) pair, without the causal skip."""
    n = cfg.batch * cfg.seq
    d, f, fe = cfg.d_model, cfg.d_ff, cfg.d_expert
    matmul = n * (
        cfg.layers_per_stage * 4 * d * f  # w_in, w_out
        + (8 * d * d if cfg.heads else 0)  # wqkv, wo
        + 2 * d  # gate
        + 4 * d * fe  # one expert per token
        + 2 * d * d  # head
    )
    attention = 4 * cfg.batch * cfg.seq * cfg.seq * d if cfg.heads else 0
    return {"matmul": matmul, "attention": attention}


def train_step_flops(cfg: FabricNetConfig) -> int:
    """3 x the forward (the backward's two products per forward product)."""
    return 3 * sum(forward_flops(cfg).values())
