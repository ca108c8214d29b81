"""Joint configuration space of the autotuner + analytical seeding (port
of ``repro/tune/space.py``).

The window/grid search (core/mapper.py) optimizes the paper's
*analytical* cycle count; the plan has knobs that count just as much on
a real machine but are invisible to that model:

* **executor policy** — which of reference / mapped / sdk runs each
  layer (the ``"auto"`` heuristic guesses; the machine decides);
* **mesh split** — how a fixed device budget divides into
  (data, row, col) macro-grid replicas
  (`launch.mesh.mesh_split_candidates`); ``None`` is the single-device
  path, the only split on one device;
* **lookahead** — the JAX package's fused-program pipeline depth
  (`NetworkPlan.lookahead`).  It is inert here (exec/run.py): the
  lookahead variants of a candidate run one program on the card;
* **sdk block / vmem_budget** — whether each sdk tile runs on
  ``sdk_whole_kernel`` or ``sdk_window_kernel``: ``block`` forces one,
  and ``block="auto"`` compares the whole-array working set with the
  byte budget (`kernels/sdk_conv.py::resolve_block`);
* **batch tiers** — the dynamic-serving plan-batch ladder.

A :class:`Candidate` pins all of them.  :func:`analytic_cost` scores the
part of a candidate the cycle model CAN see — per-layer cycles weighted
per executor, divided by the mesh parallelism the split realizes — and
:func:`shortlist` uses it to seed the measured search near-optimal:
candidates are ranked by their (policy, mesh_split) *base*, then
promoted base-major, so every measured-only knob variant (lookahead,
block, vmem, tiers — identical under the model by construction) of a
better base enters the shortlist before a worse base does.  Only the
shortlist is ever measured (repro_torch/tune/search.py).

The backend a policy is resolved for is the plan device's type,
``"cuda"`` or ``"cpu"`` (`device.resolve_device`); ``"cuda"`` takes the
JAX package's ``"tpu"`` branch, as `exec.plan._auto_executor` does.  The
devices a split is built over are ``devices`` where given, else every
visible card — or the one CPU for ``device="cpu"`` / ``backend="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from ..device import DeviceLike, resolve_device

#: Relative per-cycle wall-clock weight of each executor — a host-side
#: cost proxy (dispatch + gather/scatter overhead per super-step), NOT a
#: measurement: the placement-batched reference path issues the fewest
#: ops per cycle, the macro-parallel executor pays its gather/scatter
#: plumbing, the sdk kernel wins on the accelerator.  Only used to RANK
#: seeds; measurement settles every decision.  The "matmul" path for
#: op="matmul" layers prices like the sdk kernel: both hand the
#: super-step to one kernel with no gather/scatter plumbing per cycle.
EXEC_WEIGHTS = {"reference": 1.0, "mapped": 1.6, "sdk": 0.8,
                "matmul": 0.8}

#: Backends on which the hand-written kernels run (the JAX package's
#: ``backend == "tpu"`` test).
_KERNEL_BACKENDS = ("tpu", "cuda")


@dataclass(frozen=True)
class Candidate:
    """One point of the joint space — everything `compile_plan` and the
    serve path need to realize it.  Frozen/hashable so candidates key
    dicts in the search driver and pickle into the disk cache."""

    policy: Tuple[str, ...]     # resolved per-layer executors
    lookahead: int = 1          # pipeline depth (inert in this port)
    block: str = "auto"         # sdk tiling mode
    vmem_budget: Optional[int] = None   # sdk auto-block budget (None: env)
    tiers: Optional[Tuple[int, ...]] = None   # plan-batch ladder (None:
                                              # the power-of-two default)
    mesh_split: Optional[Tuple[int, int, int]] = None  # (data, row, col)
    #: rematerialization spec forwarded to `compile_plan(remat=...)` —
    #: None (off), "auto", a byte budget, or explicit cut indices; the
    #: autotuner can trade recompute cycles for live memory with it
    #: (training workloads — serving plans never differentiate)
    remat: object = None

    @property
    def base(self) -> Tuple:
        """The (policy, mesh_split) part the analytical model can see —
        candidates sharing a base tie under :func:`analytic_cost`."""
        return (self.policy, self.mesh_split)

    def describe(self) -> str:
        pol = ("/".join(sorted(set(self.policy)))
               if len(set(self.policy)) > 1 else self.policy[0])
        split = ("x".join(str(s) for s in self.mesh_split)
                 if self.mesh_split else "vmap")
        bits = [f"policy={pol}", f"mesh={split}",
                f"lookahead={self.lookahead}"]
        if self.block != "auto":
            bits.append(f"block={self.block}")
        if self.vmem_budget is not None:
            bits.append(f"vmem={self.vmem_budget}")
        if self.tiers is not None:
            bits.append(f"tiers={'/'.join(str(t) for t in self.tiers)}")
        if self.remat is not None:
            bits.append(f"remat={self.remat}")
        return " ".join(bits)


@dataclass(frozen=True)
class TunedConfig:
    """A persisted winner: the candidate plus the evidence it won on.
    What `memo.store_tuning` pickles and ``executor_policy="tuned"``
    loads (exec/plan.py)."""

    candidate: Candidate
    median_s: float             # winner's final-stage median wall-clock
    baseline_s: float           # the "auto" default, SAME final rounds
    rounds: int                 # final-stage rounds the medians used
    measurements: int           # total measured steps spent searching
    fleet: Tuple[str, int]      # (platform, device count) tuned on
    batch: int                  # batch profile tuned for

    @property
    def speedup(self) -> float:
        return self.baseline_s / max(self.median_s, 1e-12)

    def describe(self) -> str:
        return (f"tuned[{self.candidate.describe()}] "
                f"{self.median_s * 1e6:.0f}us vs auto "
                f"{self.baseline_s * 1e6:.0f}us "
                f"({self.speedup:.2f}x, rounds={self.rounds}, "
                f"measurements={self.measurements}, "
                f"fleet={self.fleet[0]}x{self.fleet[1]}, "
                f"batch={self.batch})")


def _backend(backend: Optional[str], device: DeviceLike) -> str:
    """The backend name a policy resolves for: ``backend`` as given, else
    the type of ``device`` (default: the card)."""
    return backend or resolve_device(device).type


def auto_policy(net, *, backend: Optional[str] = None,
                device: DeviceLike = None) -> Tuple[str, ...]:
    """The per-layer executors the ``"auto"`` heuristic resolves to —
    the search's baseline policy and first seed."""
    from ..exec.plan import _resolve_policy
    return _resolve_policy("auto", net, backend=_backend(backend, device))


def policy_candidates(net, *, backend: Optional[str] = None,
                      device: DeviceLike = None
                      ) -> Tuple[Tuple[str, ...], ...]:
    """Executor-policy seeds: the resolved auto heuristic, the uniform
    policies every layer supports (sdk only on the card and only when
    every layer's mapping owes no macro/group parallelism), and
    single-layer flips of the heaviest layer (largest cycle share —
    where a wrong heuristic guess costs the most)."""
    from ..exec.plan import _sdk_realizable
    backend = _backend(backend, device)
    auto = auto_policy(net, backend=backend)
    n = len(net.layers)
    on_kernels = backend in _KERNEL_BACKENDS
    sdk_ok = on_kernels and all(_sdk_realizable(m) for m in net.layers)
    # the "matmul" executor only accepts op="matmul" layers (exec/plan
    # rejects it at compile time otherwise), and like sdk it only pays
    # off on the card
    matmul_ok = (on_kernels
                 and all(getattr(m.layer, "op", "conv") == "matmul"
                         for m in net.layers))
    out = [auto]
    for name in (("reference", "mapped")
                 + (("sdk",) if sdk_ok else ())
                 + (("matmul",) if matmul_ok else ())):
        uniform = (name,) * n
        if uniform not in out:
            out.append(uniform)
    heavy = max(range(n), key=lambda i: net.layers[i].cycles)
    flips = ["reference", "mapped"] + (["sdk"] if sdk_ok else [])
    if (on_kernels
            and getattr(net.layers[heavy].layer, "op", "conv") == "matmul"):
        flips.append("matmul")
    for name in flips:
        if name == auto[heavy]:
            continue
        if name == "sdk" and not _sdk_realizable(net.layers[heavy]):
            continue
        flipped = auto[:heavy] + (name,) + auto[heavy + 1:]
        if flipped not in out:
            out.append(flipped)
    return tuple(out)


def analytic_cost(net, cand: Candidate) -> float:
    """Cycle-model score of a candidate's *base*: per-layer analytical
    cycles, weighted per executor (:data:`EXEC_WEIGHTS`), divided by the
    macro parallelism the mesh split realizes for mapped layers and by
    the data-axis replica count for the whole batch.  Candidates that
    differ only in lookahead / block / vmem / tiers tie exactly — those
    knobs are what measurement exists for."""
    data, row, col = cand.mesh_split or (1, 1, 1)
    total = 0.0
    for m, ex in zip(net.layers, cand.policy):
        c = m.cycles * EXEC_WEIGHTS[ex]
        if ex == "mapped":
            # a mesh only engages when it divides the sub-grid; the
            # split candidates guarantee it, so min() is the realized
            # share
            par = (min(row, m.sub_grid.r) * min(col, m.sub_grid.c))
            c /= max(par, 1)
        total += c
    return total / max(data, 1)


def mesh_devices(devices=None, device: DeviceLike = None,
                 backend: Optional[str] = None) -> list:
    """The devices a candidate's mesh split is built over: ``devices``
    where given, else those of ``device`` (every visible card, or the one
    CPU), else the one CPU for ``backend="cpu"`` and every visible card
    otherwise."""
    from ..launch import mesh as meshlib
    if devices is not None:
        return list(devices)
    if device is None and backend == "cpu":
        device = "cpu"
    return meshlib.visible_devices(device)


def mesh_split_candidates(net, batch: int, devices=None, *,
                          device: DeviceLike = None,
                          backend: Optional[str] = None) -> tuple:
    """The device splits the search measures against each other
    (`launch.mesh.mesh_split_candidates` over :func:`mesh_devices`):
    ``None`` first; on one device that is all there is."""
    from ..launch import mesh as meshlib
    return meshlib.mesh_split_candidates(
        net, batch, mesh_devices(devices, device, backend))


def enumerate_space(net, *, batch: int, device: DeviceLike = None,
                    devices=None, backend: Optional[str] = None,
                    lookaheads: Sequence[int] = (0, 1, 2),
                    blocks: Sequence[str] = ("auto",),
                    vmem_budgets: Sequence[Optional[int]] = (None,),
                    tiers_options: Sequence[Optional[Tuple[int, ...]]] =
                    (None,),
                    mesh_splits=None,
                    remats: Sequence = (None,)) -> Tuple[Candidate, ...]:
    """The full joint space (deduplicated, deterministic order): policy
    seeds x mesh splits x lookahead x sdk knobs x tier sets x remat
    specs.  sdk block / vmem variants only expand policies that actually
    run sdk layers — they are no-ops elsewhere and would only dilute the
    shortlist.  ``remats`` defaults to remat-off only (serving never
    differentiates); training tuners pass e.g. ``(None, "auto")`` to
    let the search trade recompute cycles for live memory."""
    if mesh_splits is None:
        mesh_splits = mesh_split_candidates(net, batch, devices,
                                            device=device, backend=backend)
    out = []
    for policy in policy_candidates(net, backend=backend, device=device):
        has_sdk = "sdk" in policy
        for split in mesh_splits:
            for la in lookaheads:
                for blk in (blocks if has_sdk else ("auto",)):
                    for vb in (vmem_budgets if has_sdk else (None,)):
                        for tiers in tiers_options:
                            for rm in remats:
                                c = Candidate(policy=policy, lookahead=la,
                                              block=blk, vmem_budget=vb,
                                              tiers=tiers, mesh_split=split,
                                              remat=rm)
                                if c not in out:
                                    out.append(c)
    return tuple(out)


def baseline_candidate(net, *, batch: int, device: DeviceLike = None,
                       devices=None,
                       backend: Optional[str] = None) -> Candidate:
    """What every serve entry point runs with no tuning: the auto
    executor heuristic, lookahead 1, sdk defaults, the default tier
    ladder, and `serving_mesh_for`'s mesh over :func:`mesh_devices` — the
    champion each search carries into its final round, so the reported
    speedup is always relative to the real default."""
    from ..launch import mesh as meshlib
    split = meshlib.mesh_split(meshlib.serving_mesh_for(
        net, batch, mesh_devices(devices, device, backend)))
    return Candidate(policy=auto_policy(net, backend=backend, device=device),
                     lookahead=1, mesh_split=split)


def shortlist(net, cands: Sequence[Candidate], k: int, *,
              baseline: Optional[Candidate] = None) -> Tuple[Candidate, ...]:
    """Analytical seeding: the ``k`` candidates the search will actually
    measure.  Bases — distinct (policy, mesh_split) pairs — are ranked
    by :func:`analytic_cost` (ties keep first-seen order), and
    candidates promote base-major: every variant of a better base before
    any of a worse one, so the measured-only knobs of the
    model-predicted winner are always explored first.  ``baseline`` is
    forced in (displacing the tail when full): a winner is only
    meaningful measured against the default."""
    if k < 1:
        raise ValueError(f"shortlist needs k >= 1, got {k}")
    cands = list(cands)
    if baseline is not None and baseline not in cands:
        cands.append(baseline)
    order: dict = {}
    for c in cands:
        order.setdefault(c.base, len(order))
    ranked = sorted(order, key=lambda b: (analytic_cost(
        net, next(c for c in cands if c.base == b)), order[b]))
    short = [c for b in ranked for c in cands if c.base == b][:k]
    if baseline is not None and baseline not in short:
        short[-1:] = [baseline]
    return tuple(short)
