"""FabricNet — the flagship training workload of the fabric, the
counterpart of ``incubator_brpc_tpu/models/fabricnet.py``, over the fabric
mesh with every rank on one card.

The JAX package ``shard_map``s one training step over the five fabric axes:
the batch over dp x ep, the sequence over sp, a Megatron MLP whose hidden
dimension is sharded over tp and merged by a ``psum``, a GPipe ring over pp,
ring attention (or, with ``heads = 0``, the ring mean) over sp, and a
static round-robin MoE whose tokens cross ep by ``all_to_all``. Here one
controller computes every rank at once, as JAX's eight virtual CPU devices
do, on tensors that carry the ranks in their leading dimensions
(``parallel/collective.py``):

- a stage reads ``(G mbs, S, d)``: the microbatch of each of the G = dp x ep
  data ranks (``mbs`` rows each, in (dp, ep) order, as ``batch_specs``
  places them) over the whole sequence, whose sp blocks are the sp ranks'
  in order. Everything but the MLP is computed once for the tp ranks, which
  JAX computes alike; the pipeline's stages run in turn;
- the MLP: ``gelu(n @ w_in)`` for every tp rank's columns in one product,
  then each rank's partial ``h_t @ w_out_t`` (one batched product) and the
  ``psum`` over tp, :func:`~incubator_brpc_tpu_torch.parallel.collective.merge`
  in rank order;
- the sequence block: ring attention over the mesh's sp (``sp`` K3 folds a
  microbatch and stage, and its K3 backward), or, with ``heads = 0``, K4f
  with the mesh's sp: each rank's block mean folded around the ring in the
  rank's own order, with the last MLP layer's residual add;
- the MoE: token ``r`` of a rank goes to ep rank ``r % ep`` and there to
  local expert ``r' % e_local`` of the tokens it receives, exactly as
  ``_moe``'s grouping, tiled ``all_to_all`` and reshape route it. The
  routing is static, so it is composed once into one gather of the stage's
  rows (:func:`_moe_routes`, computed by running ``_moe``'s grouping and
  :func:`~incubator_brpc_tpu_torch.parallel.collective.partition_exchange`
  on the row numbers); the experts of every rank run in one batched product
  a weight matrix, and the back exchange and ungrouping is the inverse
  gather before K4e-b, which reads the routed rows in token order. Where
  the routing keeps every token in place (ep = 1 with each rank's tokens
  contiguous, as on one rank) there is no gather: K4e-b reads the experts'
  output in their layout ``(e, t / e, d)``;
- GPipe over pp: ``m + pp - 1`` ticks, stage ``p`` taking microbatch ``tick
  - p`` from stage ``p - 1`` (the ``ppermute`` handoff); the ticks on which
  JAX computes a stage on no microbatch (``valid`` false) are skipped: JAX's
  ``where`` gives them exact zeros in both passes
  (``tests/test_torch_fabricnet.py`` holds that), and the ``psum`` over pp
  that broadcasts the last stage's outputs adds only zeros to them;
- the loss: each data rank's local mean (K4e-d, once a dp x ep x sp block)
  and their ``pmean`` over every rank, in rank order; K4e-d's gradient is
  for that mean, ``1 / (n D)`` with D the data ranks.

JAX's ``shard_map(check_vma=False)`` transposes each collective so that the
gradient of every parameter is that of the global function (the parity
tests hold this); autograd through the stacked tensors gives the same
gradient, with its sums in another order.

Parameters are a plain dict with JAX's names and shapes, each stage-stacked
over the mesh's ``pp``: ``w_in``, ``w_out``, ``moe_w1`` and ``moe_w2`` (the
``experts_per_rank x ep`` experts, rank by rank), ``gate``, ``head``, and
with heads ``wqkv`` and ``wo``. The einsums go to ``torch.matmul``
(cuBLAS on the card), as the JAX package left them to XLA. Each residual
add and the RMS norm that reads its sum, and each GeLU, are K4
(``ops/elementwise.py``: hand-written kernels on the card, forward and
backward). So is the rest of what XLA fuses around the matrix products
(K4e): the MoE's gate and combine with the last residual add
(``moe_combine``, forward and backward), the loss with its gradient
(``mse_loss_fwd``), and the SGD update over every leaf in one launch
(``ops/update.py`` ``sgd_update_multi``), which rounds as JAX does: the
learning rate in the parameters' dtype, and in float32 one fused
multiply-add.

The train step updates the parameters **in place** and returns the same
dict with the loss. Its autograd leaves are the finest slices the forward
reads (one a stage and layer of ``w_in`` and ``w_out``, one a stage and
projection of ``wqkv``, one a stage of the rest; ``_weights``), so the
backward forms no gradient of a whole parameter, as the reference's donated
``jax.jit`` step forms none; the backward starts from K4e-d's gradient of
the output. Schedules:

- ``"fused"``: one forward and backward over the batch (its
  ``microbatches`` the pipeline's), then the update;
- ``"serialized"`` and ``"overlapped"``: each rank's local batch cut into
  ``microbatches`` contiguous row slices (``_microbatch_slices``), each a
  forward and backward of its own with one inner microbatch; the gradients
  accumulate per leaf in the parameters' dtype (``acc = g_0``, then ``acc +
  g_m``, each ``g_m`` already summed over the ranks), the loss in float32,
  and the parameters take one scaled update after the last slice, returning
  ``loss_acc / M`` in float32. Across devices the two differ in whether
  slice m's gradient reductions are pinned before slice m + 1's forward;
  on one card there is no barrier to place, so both run the same ops and
  give byte-identical losses and parameters, as the reference's do.

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
from incubator_brpc_tpu_torch.parallel.collective import merge, partition_exchange
from incubator_brpc_tpu_torch.parallel.mesh import FabricMesh, make_fabric_mesh
from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

SCHEDULES = ("fused", "serialized", "overlapped")
Params = Dict[str, torch.Tensor]
# the forward's view of the parameters (_weights): {"stages": [a dict a
# stage of tensors or lists of them], "head": tensor}
Weights = Dict[str, Union[torch.Tensor, List[Dict[str, Union[torch.Tensor, List[torch.Tensor]]]]]]


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


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What a forward needs beyond the weights: the config, the mesh and the
    MoE's routes (:func:`_moe_routes`; None when every token stays in
    place)."""

    cfg: FabricNetConfig
    mesh: FabricMesh
    routes: Optional[Tuple[torch.Tensor, torch.Tensor]]

    @property
    def shape(self) -> Dict[str, int]:
        return self.mesh.shape

    @property
    def data_ranks(self) -> int:
        """G, the dp x ep ranks the batch is sharded over."""
        return self.shape["dp"] * self.shape["ep"]


def _moe_routes(cfg: FabricNetConfig, shape: Mapping[str, int], device
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """``(dispatch, combine)``: the rows of a stage's ``(G mbs, S, d)`` input,
    flattened, in the order the experts read them (``dispatch``: expert by
    expert, ``experts_per_rank x ep`` of them, each the tokens ``_moe``
    sends it from every (dp, sp) rank in rank order), and the inverse
    permutation (``combine``: ``_moe``'s back exchange and ungrouping, the
    exact inverse of its routing). Computed by running ``_moe``'s grouping,
    its tiled ``all_to_all`` (:func:`partition_exchange`) and its expert
    reshape on the row numbers. None when ``dispatch`` is the expert layout
    of the rows in place, ``rows.reshape(N / e, e).T``."""
    dp, sp, ep = shape["dp"], shape["sp"], shape["ep"]
    e_local = cfg.experts_per_rank
    sl = cfg.seq // sp
    mbs = cfg.batch // (dp * ep) // cfg.microbatches
    t = mbs * sl  # a rank's tokens, r = b sl + j
    rows = torch.arange(dp * ep * mbs * cfg.seq).reshape(dp, ep, mbs, sp, sl)
    tokens = rows.permute(0, 3, 1, 2, 4).reshape(dp * sp, ep, t)  # rank (dp, sp, ep)
    # group by destination (token r -> ep rank r % ep), chunk-contiguous
    grouped = tokens.reshape(dp * sp, ep, t // ep, ep).transpose(2, 3).reshape(dp * sp, ep, t)
    routed = partition_exchange(grouped.transpose(0, 1), "ep", split_dim=1, concat_dim=1)
    # routed token r' -> local expert r' % e_local: (ep, e_local, dp sp, t / e_local)
    xr = routed.reshape(ep, dp * sp, t // e_local, e_local).permute(0, 3, 1, 2)
    dispatch = xr.reshape(-1)
    n = dispatch.numel()
    if ep == 1 and torch.equal(dispatch, torch.arange(n).reshape(n // e_local, e_local).T.reshape(-1)):
        return None
    return dispatch.to(device), torch.argsort(dispatch).to(device)


def _plan(cfg: FabricNetConfig, mesh: FabricMesh) -> _Plan:
    return _Plan(cfg, mesh, _moe_routes(cfg, mesh.shape, mesh.device))


def _mlp(w_in_l, w_out_l, x, tp: int):
    """``_mlp_tp``: the hidden dimension sharded over ``tp``, every rank's
    columns in one product and GeLU, each rank's partial product, and the
    ``psum`` over tp in rank order (none with tp = 1)."""
    h = gelu(x @ w_in_l)
    if tp == 1:
        return h @ w_out_l
    f, d = w_out_l.shape
    hs = h.reshape(-1, tp, f // tp).transpose(0, 1)  # (tp, rows, f / tp)
    partial = torch.bmm(hs, w_out_l.reshape(tp, f // tp, d))
    return merge(partial, "tp").reshape(*x.shape[:-1], d)


def _moe(moe_w1, moe_w2, gate_w, x, s, routes):
    """``_moe`` over ep, added to the residual stream ``s``: the gate's
    logit, the tokens routed to the experts (:func:`_moe_routes`; in place
    when ``routes`` is None), the experts in one batched product each, and
    K4e-b's gate and combine, which reads the experts' output in token order
    (or, in place, in their layout)."""
    e = moe_w1.shape[0]
    shape, d = x.shape, x.shape[-1]
    tokens = x.reshape(-1, d)
    n = tokens.shape[0]
    logit = tokens @ gate_w  # (n, 1); its sigmoid is K4e-b's
    if routes is None:
        xr = tokens.reshape(n // e, e, d).transpose(0, 1)  # (e, n / e, d)
    else:
        xr = tokens.index_select(0, routes[0]).reshape(e, n // e, d)
    h = gelu(torch.bmm(xr, moe_w1))
    yr = torch.bmm(h, moe_w2)
    if routes is not None:
        yr = yr.reshape(n, d).index_select(0, routes[1]).reshape(1, n, d)
    return moe_combine(s.reshape(n, d), yr, logit).reshape(shape)


def _ring_attn_block(wqkv, wo, heads: int, x, sp: int):
    """Causal ring attention over the sp ring with the stage's projections."""
    b, t, d = x.shape
    q, k, v = ((x @ wqkv[j]).reshape(b, t, heads, d // heads) for j in range(3))
    out = ring_attention(q, k, v, sp=sp, causal=True)
    return out.reshape(b, t, d) @ wo


def _stage_fn(w: Weights, plan: _Plan, x):
    """One pipeline stage: L residual MLP layers, the sequence block (ring
    attention, or the ring mean when heads = 0), and the MoE block. Each
    residual add goes with the norm that reads its sum (``add_rms_norm``:
    one K4a forward, one K4b backward that also takes the sum's own
    gradient). The last add is K4e-b's, with the MoE's gate. With heads =
    0 the last MLP layer's add goes with the ring mean, ``x +
    _ring_context(x)`` (K4f, which writes only that sum), and the MoE's
    norm reads the sum with no delta, its K4b still taking the sum's own
    gradient."""
    heads, tp, sp = plan.cfg.heads, plan.shape["tp"], plan.shape["sp"]
    s, delta = x, None
    for l in range(len(w["w_in"])):
        s, n = add_rms_norm(s, delta)
        delta = _mlp(w["w_in"][l], w["w_out"][l], n, tp)
    if heads:
        s, n = add_rms_norm(s, delta)
        s, n = add_rms_norm(s, _ring_attn_block(w["wqkv"], w["wo"], heads, n, sp))
    else:
        s, n = add_rms_norm(ring_mean_add(s, delta, sp))
    return _moe(w["moe_w1"], w["moe_w2"], w["gate"], n, s, plan.routes)


def _weights(params: Params, heads: int) -> Weights:
    """The weights as the forward reads them, each the finest slice it uses:
    views of ``params``, a dict a pipeline stage (one a layer for ``w_in``
    and ``w_out``, one a projection for ``wqkv``), and ``head`` whole. The
    train step makes each view an autograd leaf, so no gradient of a whole
    parameter is ever formed."""
    stages = []
    for p in range(params["w_in"].shape[0]):
        w = {k: params[k][p] for k in ("moe_w1", "moe_w2", "gate")}
        w["w_in"], w["w_out"] = list(params["w_in"][p]), list(params["w_out"][p])
        if heads:
            w["wqkv"], w["wo"] = list(params["wqkv"][p]), params["wo"][p]
        stages.append(w)
    return {"stages": stages, "head": params["head"]}


def _leaves(w: Weights):
    """The tensors of ``w``, in a fixed order: stage by stage, then head."""
    for stage in w["stages"]:
        for v in stage.values():
            yield from v if isinstance(v, list) else (v,)
    yield w["head"]


def _as_leaves(w: Weights) -> Weights:
    """``w`` with each tensor a fresh autograd leaf."""
    leaf = lambda t: t.detach().requires_grad_()  # noqa: E731
    return {"stages": [{k: [leaf(t) for t in v] if isinstance(v, list) else leaf(v)
                        for k, v in stage.items()} for stage in w["stages"]],
            "head": leaf(w["head"])}


def _pipeline(stages: List[Callable], xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """GPipe over the stages: ``m + pp - 1`` ticks; at tick ``k`` stage ``p``
    takes microbatch ``k - p``, stage 0 from ``xs`` and the others from the
    stage before (the ``ppermute`` handoff of the tick before); the last
    stage's outputs, one a microbatch. A stage with no microbatch at a tick
    computes nothing (JAX computes it and discards it with exact zeros)."""
    pp, m = len(stages), len(xs)
    buf, outs = [None] * pp, [None] * m
    for tick in range(m + pp - 1):
        sent = [None] * pp
        for p in range(pp):
            i = tick - p
            if not 0 <= i < m:
                continue
            out = stages[p](xs[i] if p == 0 else buf[p])
            if p == pp - 1:
                outs[i] = out
            else:
                sent[p + 1] = out
        buf = sent
    return outs


def _local_forward(plan: _Plan, w: Weights, x: torch.Tensor,
                   microbatches: int = 0) -> torch.Tensor:
    """The forward of every rank: each data rank's local rows cut into
    ``microbatches`` contiguous microbatches (``x.reshape(m, bl // m, sl,
    d)`` on each rank; a microbatch of every data rank is one stage input),
    GPipe over the stages, then the head. ``microbatches`` overrides the
    config's (a sliced schedule's slice runs one)."""
    b, t, d = x.shape
    g = plan.data_ranks
    m = microbatches or plan.cfg.microbatches
    stages = [lambda h, ws=ws: _stage_fn(ws, plan, h) for ws in w["stages"]]
    outs = _pipeline(stages, _microbatch_slices(plan, x, m))
    out = torch.stack([o.reshape(g, b // (g * m), t, d) for o in outs], dim=1)
    return out.reshape(b, t, d) @ w["head"]


def _loss(plan: _Plan, out: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, d_out)``: each data rank's local ``mean((out - y)^2)`` over
    its (dp x ep rows, sp block) (K4e-d, the gradient for the ``pmean``),
    and their ``pmean`` over every rank of the mesh, summed in rank order
    in the loss's dtype: JAX's ``_local_loss``."""
    g, sp = plan.data_ranks, plan.shape["sp"]
    if g * sp == 1:
        return mse_loss_fwd(out, y)
    b, t, d = out.shape
    ov, yv = (a.reshape(g, b // g, sp, t // sp, d) for a in (out, y))
    d_out = torch.empty_like(out)
    dv = d_out.view(g, b // g, sp, t // sp, d)
    local = {}
    for i in range(g):
        for j in range(sp):
            local[i, j], dv[i, :, j] = mse_loss_fwd(ov[i, :, j], yv[i, :, j], ranks=g * sp)
    acc = None
    for r in range(plan.mesh.size):
        c = plan.mesh.coords(r)
        v = local[c["dp"] * plan.shape["ep"] + c["ep"], c["sp"]]
        acc = v if acc is None else acc + v
    return acc / plan.mesh.size, d_out


def _local_loss(plan: _Plan, w: Weights, x, y, microbatches: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, out, d_out)``: the output (differentiable), the loss of
    :func:`_loss` (on one rank ``mean((out - y)^2)`` summed in float32 and
    rounded to the model's dtype as ``jnp.mean`` does), and its gradient
    with respect to ``out`` (K4e-d)."""
    out = _local_forward(plan, w, x, microbatches)
    loss, d_out = _loss(plan, out.detach(), y)
    return loss, out, d_out


def _grads(plan: _Plan, views: Weights, x, y, microbatches: int = 0):
    """``(loss, grads)``: the loss and its gradient for each leaf of
    ``views`` in ``_leaves`` order, each view a fresh autograd leaf."""
    leaves = _as_leaves(views)
    with torch.enable_grad():
        loss, out, d_out = _local_loss(plan, leaves, x, y, microbatches)
        return loss, torch.autograd.grad(out, list(_leaves(leaves)), d_out)


def _microbatch_slices(plan: _Plan, x: torch.Tensor, m: int) -> List[torch.Tensor]:
    """``[slice 0, ..., slice m-1]`` of ``x`` ``(B, ...)``: each data rank
    splits its local rows into ``m`` contiguous slices, and slice ``i`` is
    every rank's ``i``-th, in rank order (``_microbatch_slicer``) — not a
    contiguous block of the global batch, which would live on a subset of
    the dp x ep ranks."""
    g, b = plan.data_ranks, x.shape[0]
    xs = x.reshape(g, m, b // (g * m), *x.shape[1:])
    return [xs[:, i].reshape(b // m, *x.shape[1:]) for i in range(m)]


# -- entry points ----------------------------------------------------------------


def _mesh(mesh: Optional[FabricMesh], device: DeviceLike) -> FabricMesh:
    if mesh is None:
        return make_fabric_mesh(1, device=device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh


def validate_config(cfg: FabricNetConfig, mesh: FabricMesh) -> None:
    """The reference's static divisibility checks over the mesh's axes."""
    dp, tp, sp, ep = (mesh.shape[a] for a in ("dp", "tp", "sp", "ep"))
    checks = [
        (cfg.d_ff % tp == 0, "d_ff must divide by tp"),
        (cfg.batch % (dp * ep) == 0, "batch must divide by dp*ep"),
        ((cfg.batch // (dp * ep)) % cfg.microbatches == 0, "local batch must divide microbatches"),
        (cfg.seq % sp == 0, "seq must divide by sp"),
        (not cfg.heads or cfg.d_model % cfg.heads == 0, "d_model must divide by heads"),
    ]
    for ok, msg in checks:
        if not ok:
            raise ValueError(msg)
    t = (cfg.batch // (dp * ep) // cfg.microbatches) * (cfg.seq // sp)
    if t % ep:
        raise ValueError("local tokens must divide by ep")
    if t % (cfg.experts_per_rank * ep):
        raise ValueError("local tokens must divide experts")


def make_forward_step(
    cfg: FabricNetConfig, mesh: Optional[FabricMesh] = None, device: DeviceLike = None
) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """``(params, x) -> (B, S, d)`` output, without gradients."""
    mesh = _mesh(mesh, device)
    validate_config(cfg, mesh)
    plan = _plan(cfg, mesh)

    @torch.no_grad()
    def fwd(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _local_forward(plan, _weights(params, cfg.heads), x)

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
    plan = _plan(cfg, mesh)

    # the fused step is one slice of cfg.microbatches; a sliced step is
    # cfg.microbatches slices of one
    sliced = schedule != "fused"
    m, inner = (cfg.microbatches, 1) if sliced else (1, cfg.microbatches)

    @torch.no_grad()
    def step(params: Params, x: torch.Tensor, y: torch.Tensor):
        views = _weights(params, cfg.heads)
        xs, ys = _microbatch_slices(plan, x, m), _microbatch_slices(plan, y, m)
        acc = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device) if sliced else None
        for i in range(m):
            loss, grads = _grads(plan, views, xs[i], ys[i], microbatches=inner)
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


def forward_flops(cfg: FabricNetConfig, pp: int = 1) -> Dict[str, int]:
    """FLOPs (2 per multiply-add) of one forward over the whole batch, from
    the shapes, through ``pp`` stages: the matrix products, and attention's
    two products over every (query, key) pair of the whole sequence (the sp
    ring's included), without the causal skip."""
    n = cfg.batch * cfg.seq
    d, f, fe = cfg.d_model, cfg.d_ff, cfg.d_expert
    stage = (
        cfg.layers_per_stage * 4 * d * f  # w_in, w_out
        + (8 * d * d if cfg.heads else 0)  # wqkv, wo
        + 2 * d  # gate
        + 4 * d * fe  # one expert per token
    )
    matmul = n * (pp * stage + 2 * d * d)  # + head
    attention = pp * 4 * cfg.batch * cfg.seq * cfg.seq * d if cfg.heads else 0
    return {"matmul": matmul, "attention": attention}


def train_step_flops(cfg: FabricNetConfig, pp: int = 1) -> int:
    """3 x the forward (the backward's two products per forward product)."""
    return 3 * sum(forward_flops(cfg, pp).values())
