"""`NetworkPlan` — one compiled execution-plan IR for the executors
(port of ``repro/exec/plan.py``).

`compile_plan` lowers a `NetworkMapping` **once** into a static
per-layer plan; `execute_plan` (exec/run.py) then runs the forward.
Compilation is a staged **pass pipeline** over a `PlanDraft` — each
pass takes the draft and returns an updated one::

    validate ─ resolve_executors ─ check_glue ─ estimate_memory
             ─ segment ─ schedule ─ (freeze → NetworkPlan)

* **validate** — whole-plan input legality (batch, a batch the mesh's
  data axis does not divide is refused);
* **resolve_executors** — per-layer executor legality (sdk
  realizability, matmul op match) and the mesh decision
  (`macro_mesh_fits`), so dispatch never re-fits;
* **check_glue** — inter-layer glue: plain chain / DenseNet concat
  classified from channel arithmetic (exec/glue.py) for CNNs, or the
  mapping's explicit `GlueSpec` tuple (transformer lowerings) validated
  by carry simulation — a mis-chained network fails at compile, not
  mid-forward;
* **estimate_memory** — per-layer live-activation + shifted-weight
  byte estimates from the LayerMapping itself (exec/memory.py);
* **segment** — rematerialization boundaries under the requested
  peak-memory budget (exec/remat.py; concat groups never split);
* **schedule** — the super-step schedule (`LayerSchedule`) with the
  steps==cycles assertion evaluated here, at compile time.

The plan's device type takes the place of the JAX package's
``interpret`` flag: ``_auto_executor`` picks the ``sdk`` and ``matmul``
kernels for a ``"cuda"`` plan exactly where the JAX package picks them
on a TPU.
Plans are frozen, hashable and picklable; they join the memo result /
disk cache keyed on mapping + resolved policy + mesh shape + device +
batch + flags.  The live mesh (`launch.mesh.Mesh`) stays out of the IR:
``NetworkPlan.mesh_axes`` records its shape, each ``LayerPlan.use_mesh``
whether that layer runs over it, and `execute_plan` binds the live mesh
and holds it to the compile mesh.  A mesh whose devices are not of the
plan's device type (or are mixed) is refused at compile.

``chained=False`` compiles a *layerwise* plan: per-layer executor
dispatch with no inter-layer glue (``GlueSpec(kind="layerwise")``), for
callers that own the plumbing between layers (`cnn.models.apply_cnn`
through `exec.run.apply_layer`); `execute_plan` refuses it.

``executor_policy="tuned"`` serves the autotuner's persisted winner for
(net, the plan device's fleet, batch) — `repro_torch.tune` — and falls
back to ``"auto"`` when nothing was tuned.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence, Tuple, Union

from ..core import memo
from ..core.types import GlueSpec, NetworkMapping
from ..cnn.mapped_net import LayerSchedule, check_steps, layer_schedule
from ..device import DeviceLike, resolve_device
from ..launch.mesh import check_mesh, mesh_platform
from ..launch.sharding import macro_mesh_fits
from . import memory as memlib
from . import remat as rematlib
from .glue import resolve_chain

#: Executors a plan can dispatch a layer to in this port.  "matmul" runs
#: ``op="matmul"`` layers on the matmul kernels
#: (kernels/matmul_exec.py: tetris_matmul / grouped_matmul).
EXECUTORS = ("reference", "mapped", "sdk", "matmul")

#: Anything compile_plan accepts as a policy: one name (or "auto") for
#: every layer, a per-layer sequence of names, or a callable
#: ``LayerMapping -> name``.
PolicyLike = Union[str, Sequence[str], Callable]


@dataclass(frozen=True)
class LayerPlan:
    """Compiled execution of ONE layer, fixed at compile time."""

    mapping: object             # LayerMapping (frozen, hashable)
    executor: str               # "reference" | "mapped" | "sdk" | "matmul"
    schedule: LayerSchedule     # steps==cycles evidence (compile-time)
    glue: GlueSpec              # structured inter-layer glue (core.types)
    carry_c: int                # channels entering this layer
    use_mesh: bool = False      # over the mesh vs batched, at compile
    device: str = "cuda"        # device type the plan runs on
    block: str = "auto"         # sdk: tiling mode
    vmem_budget: int = 8 * 1024 * 1024  # sdk: resolved byte budget
    act_bytes: int = 0          # memory pass: saved input activation
    weight_bytes: int = 0       # memory pass: shifted-weight prep

    @property
    def mem_bytes(self) -> int:
        """Live bytes this layer pins during an unremat'd backward."""
        return self.act_bytes + self.weight_bytes


@dataclass(frozen=True)
class NetworkPlan:
    """Static whole-network execution plan.  ``batch`` is the batch the
    plan was compiled for (None: any batch).  ``mesh_axes`` records the
    compile mesh's (name, size) shape (None: no mesh); `execute_plan`
    binds the live mesh and holds it to these axes."""

    net: NetworkMapping
    layers: Tuple[LayerPlan, ...]
    batch: Optional[int]
    device: str = "cuda"
    #: False for a layerwise plan (`compile_plan(chained=False)`)
    chained: bool = True
    #: cross-layer pipeline depth of the JAX package's fused program.
    #: Kept in the IR so plan keys line up with the JAX package; inert
    #: here, where the forward runs eagerly layer by layer.
    lookahead: int = 1
    #: rematerialization segments — half-open (start, end) layer ranges
    #: chosen by the segment pass; None when remat was off.
    segments: Optional[Tuple[Tuple[int, int], ...]] = None
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None

    @property
    def executors(self) -> Tuple[str, ...]:
        return tuple(lp.executor for lp in self.layers)

    @property
    def total_steps(self) -> int:
        """Compile-time super-step total == NetworkMapping.total_cycles."""
        return sum(lp.schedule.steps for lp in self.layers)

    @property
    def host_dispatches(self) -> int:
        """Executor calls per forward: the eager forward calls one
        executor per layer."""
        return len(self.layers)

    def launches_per_forward(self) -> dict:
        """The kernel launches one forward makes on the card, keyed by the
        wrapper that counts them: an sdk layer launches its tile's kernel
        (``sdk_whole`` or ``sdk_window``, as ``resolve_block`` picks at the
        plan's batch) once per tile and group, a ``reference`` layer
        ``sdk_placed`` once per (tile, window shape) (on the card under
        ``no_grad``), a matmul layer one matmul (``grouped_matmul`` for
        G > 1), an attention stage one ``flash_attention``."""
        from ..kernels import sdk_conv as sk
        n = dict.fromkeys(("sdk_whole", "sdk_window", "sdk_placed",
                           "tetris_matmul", "grouped_matmul",
                           "flash_attention"), 0)
        for lp in self.layers:
            m = lp.mapping
            if lp.executor == "sdk":
                for t in m.tiles:
                    mode = sk.resolve_block(lp.block, self.batch,
                                            sk.tile_geom(m, t), m.layer,
                                            lp.vmem_budget)
                    n["sdk_" + mode] += m.group
            elif lp.executor == "reference":
                n["sdk_placed"] += len(sk.placed_layer(m).launches)
            elif lp.executor == "matmul":
                n["grouped_matmul" if m.group > 1 else "tetris_matmul"] += 1
            if lp.glue.post == "attention":
                n["flash_attention"] += 1
        return n

    @property
    def spans(self) -> Tuple[Tuple[int, int], ...]:
        """The segment ranges — one whole-net span when remat is off."""
        if self.segments is not None:
            return self.segments
        return ((0, len(self.layers)),)

    @property
    def layer_memory(self) -> Tuple[memlib.LayerMemory, ...]:
        return tuple(memlib.LayerMemory(lp.mapping.layer.name,
                                        lp.act_bytes, lp.weight_bytes)
                     for lp in self.layers)

    @property
    def peak_bytes(self) -> int:
        """Peak live-byte estimate of training through this plan *as
        segmented* (exec/memory.py peak model)."""
        return memlib.peak_bytes(self.layer_memory, self.spans)

    @property
    def unremat_peak_bytes(self) -> int:
        """The peak with every layer's residuals live at once."""
        return memlib.total_bytes(self.layer_memory)

    def describe(self) -> str:
        execs = ",".join(f"{lp.mapping.layer.name}:{lp.executor}"
                         for lp in self.layers)
        seg = f" segments={len(self.segments)}" if self.segments else ""
        tag = ("x".join(f"{n}={s}" for n, s in self.mesh_axes)
               if self.mesh_axes else "vmap")
        return (f"plan[{self.net.name}] layers={len(self.layers)} "
                f"steps={self.total_steps} device={self.device} "
                f"mesh={tag} lookahead={self.lookahead} "
                f"peak_mem={self.peak_bytes / 1e6:.1f}MB{seg} "
                f"dispatches/forward={self.host_dispatches} ({execs})")

    def describe_memory(self) -> str:
        """Per-layer memory-pass estimates, one line per layer, with
        segment boundaries marked."""
        starts = {s for s, _ in self.spans[1:]}
        lines = [f"plan[{self.net.name}] "
                 f"peak={self.peak_bytes / 1e6:.1f}MB "
                 f"unremat={self.unremat_peak_bytes / 1e6:.1f}MB "
                 f"segments={len(self.spans)}"]
        for i, lp in enumerate(self.layers):
            cut = " <- segment" if i in starts else ""
            lines.append(
                f"  {lp.mapping.layer.name}: act="
                f"{lp.act_bytes / 1e6:.2f}MB weights="
                f"{lp.weight_bytes / 1e6:.2f}MB{cut}")
        return "\n".join(lines)


def mesh_axes(mesh) -> Optional[Tuple[Tuple[str, int], ...]]:
    """Canonical (name, size) shape of a mesh — the form stored in the
    IR, used in the plan cache key, and checked at execute time."""
    if mesh is None:
        return None
    return tuple((str(n), int(s)) for n, s in mesh.shape.items())


def _sdk_realizable(mapping) -> bool:
    """sdk runs every pass and every group sequentially — it can only
    stand in for the mapping when no macro/group parallelism is owed."""
    from ..kernels.sdk_conv import sdk_conv_cycles
    return sdk_conv_cycles(mapping) == mapping.cycles


def _auto_executor(mapping, *, backend: str) -> str:
    """Per-layer heuristic: the hand-written kernels on the card —
    ``"matmul"`` for op="matmul" layers, ``"sdk"`` for conv layers owing
    no macro/group parallelism (exactly the JAX package's ``"tpu"``
    branch); the macro-parallel executor whenever a non-degenerate
    sub-grid must be realized; otherwise the placement-batched reference
    path."""
    if backend in ("tpu", "cuda"):
        if getattr(mapping.layer, "op", "conv") == "matmul":
            return "matmul"
        if _sdk_realizable(mapping):
            return "sdk"
    if mapping.sub_grid.p > 1 or mapping.group_rounds < mapping.group:
        return "mapped"
    return "reference"


def _resolve_policy(policy: PolicyLike, net: NetworkMapping, *,
                    backend: str) -> Tuple[str, ...]:
    if callable(policy):
        per_layer = [policy(m) for m in net.layers]
    elif isinstance(policy, str):
        per_layer = [policy] * len(net.layers)
    else:
        per_layer = list(policy)
        if len(per_layer) != len(net.layers):
            raise ValueError(
                f"policy lists {len(per_layer)} executors for "
                f"{len(net.layers)} layers")
    out = []
    for name, m in zip(per_layer, net.layers):
        if name == "auto":
            name = _auto_executor(m, backend=backend)
        if name not in EXECUTORS:
            raise ValueError(f"unknown executor {name!r} "
                             f"(expected one of {EXECUTORS} or 'auto')")
        out.append(name)
    return tuple(out)


# ---------------------------------------------------------------------------
# the pass pipeline


@dataclass(frozen=True)
class PlanDraft:
    """The intermediate the compile passes thread — compile_plan's
    resolved inputs plus one field per analysis, each filled by its
    pass and read by later ones.  Frozen: passes return an updated copy
    (`dataclasses.replace`), never mutate."""

    net: NetworkMapping
    execs: Tuple[str, ...]
    mesh: object                    # the LIVE mesh (not in the final IR)
    batch: Optional[int]
    chained: bool
    device: str
    block: str
    vmem_budget: int
    lookahead: int
    remat: object                   # canonical spec (exec.remat)
    # pass products
    use_mesh: Optional[Tuple[bool, ...]] = None        # resolve_executors
    glue: Optional[Tuple[GlueSpec, ...]] = None        # check_glue
    carries: Optional[Tuple[int, ...]] = None          # check_glue
    mem: Optional[Tuple[memlib.LayerMemory, ...]] = None  # estimate_memory
    segments: Optional[Tuple[Tuple[int, int], ...]] = None  # segment
    schedules: Optional[Tuple[LayerSchedule, ...]] = None   # schedule


def pass_validate(d: PlanDraft) -> PlanDraft:
    """Whole-plan input legality."""
    if d.batch is not None and d.batch < 1:
        raise ValueError(f"batch must be >= 1, got {d.batch}")
    if (d.mesh is not None and "data" in d.mesh.axis_names
            and d.batch is not None and d.batch % d.mesh.shape["data"]):
        # refuse rather than quietly run the whole net off the mesh:
        # ragged batches pad to the data axis (serve_cnn pad-and-mask)
        raise ValueError(
            f"batch {d.batch} does not divide the mesh data axis "
            f"{d.mesh.shape['data']} — pad the batch to "
            f"pad_to_data_axis(batch, mesh) or drop the data axis")
    return d


def pass_resolve_executors(d: PlanDraft) -> PlanDraft:
    """Executor legality per layer, and whether each runs over the
    mesh."""
    use = []
    for m, ex in zip(d.net.layers, d.execs):
        lay = m.layer
        if ex == "sdk" and not _sdk_realizable(m):
            raise ValueError(
                f"{lay.name}: executor 'sdk' runs passes/groups "
                f"sequentially and cannot realize sub-grid "
                f"{m.sub_grid.r}x{m.sub_grid.c} / {m.group_rounds} group "
                f"rounds — use 'mapped'")
        if ex == "matmul" and getattr(lay, "op", "conv") != "matmul":
            raise ValueError(
                f"{lay.name}: executor 'matmul' requires op='matmul' "
                f"(this layer is op={getattr(lay, 'op', 'conv')!r})")
        use.append(ex == "mapped"
                   and macro_mesh_fits(d.mesh, m.sub_grid.r, m.sub_grid.c,
                                       batch=d.batch))
    return replace(d, use_mesh=tuple(use))


def pass_check_glue(d: PlanDraft) -> PlanDraft:
    """Classify / validate inter-layer glue and the carry channel count
    entering each layer."""
    net = d.net
    n = len(net.layers)
    if not d.chained:
        return replace(
            d, glue=tuple(GlueSpec(kind="layerwise") for _ in range(n)),
            carries=tuple(m.layer.ic for m in net.layers))
    glue, carries = [], []
    carry_c = net.layers[0].layer.ic
    saved: list = []                # channel widths of GlueSpec.save stack
    for i, m in enumerate(net.layers):
        lay = m.layer
        carries.append(carry_c)
        if net.glue is not None:
            spec = net.glue[i]
            carry_c, saved = _check_explicit_glue(net, i, spec, carry_c,
                                                  saved)
        else:
            if i + 1 < n:
                nxt = net.layers[i + 1].layer
                spec = GlueSpec(kind=resolve_chain(
                    lay.name, lay.oc, carry_c, nxt.name, nxt.ic))
            else:
                spec = GlueSpec(kind="last")
            carry_c = net.layers[i + 1].layer.ic if i + 1 < n else lay.oc
        glue.append(spec)
    if net.glue is not None and saved:
        raise ValueError(
            f"{net.name}: {len(saved)} saved residual input(s) never "
            f"consumed by a kind='residual' glue")
    return replace(d, glue=tuple(glue), carries=tuple(carries))


def _check_explicit_glue(net: NetworkMapping, i: int, spec: GlueSpec,
                         carry_c: int, saved: list):
    """Compile-time channel simulation of one explicit-glue step: what
    `resolve_chain` does for inferred CNN glue, generalized to the
    save/residual stack and the attention stage.  Returns the carry
    channel count entering layer i+1 and the updated saved stack —
    raising the mis-chaining error here, never mid-forward."""
    lay = net.layers[i].layer
    last = i + 1 == len(net.layers)
    if lay.ic != carry_c:
        raise ValueError(
            f"{lay.name}: glue carries {carry_c} channels into a layer "
            f"with ic={lay.ic}")
    if spec.kind == "layerwise" or (spec.kind == "last" and not last):
        raise ValueError(
            f"{lay.name}: glue kind {spec.kind!r} is invalid for chained "
            f"layer {i} of {len(net.layers)}")
    out_c = lay.oc
    if spec.post == "attention":
        hq, hkv, hd = spec.heads
        if getattr(lay, "op", "conv") != "matmul" \
                or lay.oc != (hq + 2 * hkv) * hd:
            raise ValueError(
                f"{lay.name}: post='attention' with heads "
                f"({hq}q, {hkv}kv, {hd}d) needs an op='matmul' layer "
                f"with oc={(hq + 2 * hkv) * hd}, got op="
                f"{getattr(lay, 'op', 'conv')!r} oc={lay.oc}")
        out_c = hq * hd
    saved = list(saved)
    if spec.save:
        saved.append(carry_c)
    if spec.kind == "residual":
        if not saved:
            raise ValueError(f"{lay.name}: kind='residual' with no saved "
                             f"input (no earlier glue set save=True)")
        res_c = saved.pop()
        if res_c != out_c:
            raise ValueError(
                f"{lay.name}: residual add of {res_c} saved channels "
                f"onto {out_c} output channels")
        nxt_c = out_c
    elif spec.kind == "concat":
        nxt_c = carry_c + out_c
    else:                               # "chain" or final "last"
        nxt_c = out_c
    if not last and net.layers[i + 1].layer.ic != nxt_c:
        nxt = net.layers[i + 1].layer
        raise ValueError(
            f"cannot chain {lay.name} ({spec.kind}, {nxt_c} carry "
            f"channels) into {nxt.name} (ic={nxt.ic})")
    return nxt_c, saved


def pass_estimate_memory(d: PlanDraft) -> PlanDraft:
    """Per-layer live-byte estimates (exec/memory.py).  ``batch=None``
    plans price a single example."""
    mem = memlib.network_memory(d.net, d.carries,
                                d.batch if d.batch else 1)
    return replace(d, mem=mem)


def pass_segment(d: PlanDraft) -> PlanDraft:
    """Choose rematerialization boundaries (exec/remat.py).  Chained
    plans cut only at the glue pass's legal boundaries; layerwise plans
    (`apply_cnn`, which owns its own glue) may cut anywhere."""
    if d.remat is None:
        return d                    # remat off: segments stays None
    if d.chained:
        allowed = rematlib.allowed_cuts(d.glue)
    else:
        allowed = tuple(range(len(d.net.layers) - 1))
    return replace(d, segments=rematlib.plan_segments(d.mem, allowed,
                                                      d.remat))


def pass_schedule(d: PlanDraft) -> PlanDraft:
    """Super-step schedules, with steps==cycles asserted per layer —
    at compile time, never at dispatch."""
    scheds = []
    for m in d.net.layers:
        check_steps(m)
        scheds.append(layer_schedule(m))
    return replace(d, schedules=tuple(scheds))


#: The pipeline, in order.  Each pass is PlanDraft -> PlanDraft.
PASSES: Tuple[Callable[[PlanDraft], PlanDraft], ...] = (
    pass_validate, pass_resolve_executors, pass_check_glue,
    pass_estimate_memory, pass_segment, pass_schedule)


def _freeze(d: PlanDraft) -> NetworkPlan:
    """Assemble the frozen IR from a fully-analyzed draft."""
    layers = tuple(
        LayerPlan(mapping=m, executor=ex, schedule=sch, glue=g,
                  carry_c=c, use_mesh=um, device=d.device, block=d.block,
                  vmem_budget=d.vmem_budget, act_bytes=mm.act_bytes,
                  weight_bytes=mm.weight_bytes)
        for m, ex, sch, g, c, um, mm in zip(
            d.net.layers, d.execs, d.schedules, d.glue, d.carries,
            d.use_mesh, d.mem))
    return NetworkPlan(net=d.net, layers=layers, batch=d.batch,
                       device=d.device, chained=d.chained,
                       lookahead=d.lookahead,
                       segments=d.segments, mesh_axes=mesh_axes(d.mesh))


def _compile(draft: PlanDraft) -> NetworkPlan:
    for p in PASSES:
        draft = p(draft)
    return _freeze(draft)


def compile_plan(net: NetworkMapping, *,
                 executor_policy: PolicyLike = "auto",
                 mesh=None, batch: Optional[int] = None,
                 chained: bool = True,
                 device: DeviceLike = None,
                 block: Optional[str] = None,
                 vmem_budget: Optional[int] = None,
                 lookahead: Optional[int] = None,
                 remat: rematlib.RematSpec = None) -> NetworkPlan:
    """Lower ``net`` once into a :class:`NetworkPlan` for ``device``
    (default: the card; ``device="cpu"`` plans for the plain versions).

    ``executor_policy`` — ``"auto"`` (per-layer heuristic on the plan's
    device type, see `_auto_executor`), ``"tuned"`` (the autotuner's
    persisted winner for this net, the plan device's fleet and this
    batch — see `repro_torch.tune`; falls back to ``"auto"`` when
    nothing has been tuned), one executor name for every layer, a
    per-layer sequence, or a callable ``LayerMapping -> name``.
    ``mesh`` (a `launch.mesh.Mesh` over devices of the plan's type) and
    ``batch`` fix the mesh decisions (`macro_mesh_fits` per layer,
    evaluated here, never at dispatch); a batch that does not divide the
    mesh's data axis is refused here — pad it first
    (`launch.mesh.pad_to_data_axis`).
    ``chained=False`` compiles a layerwise plan (module docstring).
    ``lookahead`` (default 1) stays in the IR and is inert here;
    ``vmem_budget`` (default: ``REPRO_SDK_VMEM_BUDGET``, else 8 MiB)
    bounds the sdk executor's ``block="auto"`` whole-array working set.
    ``remat`` asks the segment pass for rematerialization boundaries:
    ``None``/``"off"``, ``"auto"``, an ``int`` peak-byte budget, or an
    explicit sequence of boundary layer indices.

    With ``executor_policy="tuned"`` any of ``lookahead`` / ``block`` /
    ``vmem_budget`` / ``remat`` left unset take the tuned values (pass
    ``remat="off"`` to force remat off under a tuned policy).

    Every layer's executed schedule is asserted equal to its
    ``LayerMapping.cycles`` here, and a mis-chained network raises the
    chaining error here too.  Results are memoized — in memory and, when
    a disk cache is configured, across processes."""
    from ..kernels.sdk_conv import default_vmem_budget
    if not net.layers:
        raise ValueError(f"{net.name}: cannot plan an empty network")
    dev = resolve_device(device).type
    check_mesh(mesh)
    if mesh is not None and mesh_platform(mesh) != dev:
        raise ValueError(
            f"mesh devices are {mesh_platform(mesh)}, the plan runs on "
            f"{dev} — build the mesh over {dev} devices")
    if executor_policy == "tuned":
        # lazy import: repro_torch.tune compiles plans, so the dependency
        # must point tune -> exec at module scope, not both ways
        from ..tune import tuned_config
        cfg = tuned_config(net, batch=batch, device=dev)
        if cfg is None:
            executor_policy = "auto"
        else:
            executor_policy = cfg.candidate.policy
            if lookahead is None:
                lookahead = cfg.candidate.lookahead
            if block is None:
                block = cfg.candidate.block
            if vmem_budget is None:
                vmem_budget = cfg.candidate.vmem_budget
            if remat is None:
                remat = cfg.candidate.remat
    if lookahead is None:
        lookahead = 1
    if lookahead < 0:
        raise ValueError(f"lookahead must be >= 0, got {lookahead}")
    if block is None:
        block = "auto"
    if block not in ("auto", "whole", "window"):
        raise ValueError(f"unknown block mode {block!r}")
    if vmem_budget is None:
        vmem_budget = default_vmem_budget()
    remat_spec = rematlib.canonical_remat(remat)
    execs = _resolve_policy(executor_policy, net, backend=dev)
    draft = PlanDraft(net=net, execs=execs, mesh=mesh, batch=batch,
                      chained=chained, device=dev, block=block,
                      vmem_budget=vmem_budget, lookahead=lookahead,
                      remat=remat_spec)
    key = (net, execs, batch, chained, dev, block, vmem_budget, lookahead,
           remat_spec, mesh_axes(mesh))

    def _compile_counted():
        _compile_counts.note(key)
        return _compile(draft)

    return memo.cached_plan(key, _compile_counted)


#: Actual `_compile` lowerings per cache key — cache hits (in-memory or
#: disk) do NOT count.  The serving tests assert every tier of a plan
#: ladder compiles exactly once per process (per cache generation).
_compile_counts = memo.BoundedCounts(512)


def compile_counts(*, net: Optional[NetworkMapping] = None,
                   batch: Optional[int] = None) -> dict:
    """Copy of the per-key compile counters, optionally filtered to one
    network mapping and/or plan batch — ``compile_counts(net=nm)``
    values of all 1 prove each (policy, mesh, device, batch) lowered
    once."""
    out = {}
    for key, n in _compile_counts.items():
        if net is not None and key[0] != net:
            continue
        if batch is not None and key[2] != batch:
            continue
        out[key] = n
    return out
