"""The port's roofline terms and op analysis (repro_torch.launch.roofline,
launch.op_analysis) against the JAX package's roofline and by hand.

``model_flops`` is the JAX module's arithmetic, held equal for every
config and shape with each package's own param count.  The H100 terms
are checked as tests/test_launch.py checks the v5e ones.  The op
counter is held to hand counts on a Megatron-style pair of matmuls on a
fake 16x16 group (each rank's share of the FLOPs and its all-reduce's
bytes), to ``FlopCounterMode`` on a plain one-device step, and shows
the units of a model amplified as the JAX module's loop-aware count
does.  Its byte rules (views free, a copy read and written, an in-place
op, a gather's rows) are held to hand counts op by op."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, get_config as j_get_config  # noqa: E402
from repro.launch import roofline as j_rl                       # noqa: E402
from repro.launch import shapes as j_shapes                     # noqa: E402
from repro.models import transformer as JT                      # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.launch import op_analysis as oa                # noqa: E402
from repro_torch.launch import roofline as rl                   # noqa: E402
from repro_torch.launch import shapes as t_shapes               # noqa: E402
from repro_torch.models import transformer as T                 # noqa: E402


@pytest.fixture(scope="module", params=ARCH_IDS)
def counts(request):
    """(JAX config, port config, JAX (n, n_active), port (n, n_active))."""
    cj, ct = j_get_config(request.param), get_config(request.param)
    return (cj, ct, (JT.count_params(cj), JT.count_params(cj, True)),
            (T.count_params(ct), T.count_params(ct, True)))


@pytest.mark.parametrize("shape", list(t_shapes.SHAPES))
def test_model_flops_equal_jax(counts, shape):
    """``model_flops`` of every config and shape, each package's config,
    shape and param counts: the same float."""
    cj, ct, nj, nt = counts
    assert nt == nj
    want = j_rl.model_flops(cj, j_shapes.SHAPES[shape], *nj)
    assert rl.model_flops(ct, t_shapes.SHAPES[shape], *nt) == want
    assert want > 0


def test_roofline_terms_on_h100_constants():
    """One second of each term at the card's peaks (test_launch.py's
    check on H100 constants); f32 at the CUDA cores' peak; a collective
    charged at its link."""
    t = rl.RooflineTerms(flops_per_chip=989e12, bytes_per_chip=3.35e12,
                         coll_link_bytes={}, chips=1,
                         model_flops_total=989e12)
    assert t.t_compute == pytest.approx(1.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_coll == 0.0
    assert t.dominant in ("compute", "memory")
    assert t.roofline_fraction == pytest.approx(1.0)
    assert t.fraction_at(2.0) == pytest.approx(0.5)
    f32 = rl.RooflineTerms(67e12, 0.0, {}, 1, 67e12, compute_dtype="f32")
    assert f32.t_compute == pytest.approx(1.0)
    assert rl.dtype_name(torch.bfloat16) == "bf16"
    assert rl.dtype_name(torch.float32) == "f32"
    coll = rl.RooflineTerms(0.0, 0.0, {"nvlink": 450e9, "network": 50e9},
                            16)
    assert coll.t_coll == pytest.approx(2.0)
    assert coll.dominant == "collective" and coll.bound == coll.t_coll
    assert coll.coll_bytes_per_chip == 500e9
    assert rl.link_of(range(8)) == "nvlink"
    assert rl.link_of(range(4, 12)) == "network"
    assert rl.link_of([0, 16, 32]) == "network"


@pytest.fixture
def fake_16x16():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _meta_dtensor(mesh, shape, placements):
    """A meta-backed DTensor of ``shape`` with ``placements``."""
    from types import SimpleNamespace
    from repro_torch.launch import dryrun
    return dryrun.meta_arg(torch.empty(shape, device="meta"),
                           SimpleNamespace(mesh=mesh,
                                           placements=tuple(placements)))


def test_op_counter_on_two_sharded_matmuls(fake_16x16):
    """x (256, 4096) split over "data", w1 (4096, 8192) split on its
    columns and w2 (8192, 4096) on its rows over "model": each matmul is
    1/256 of its 1.718e10 FLOPs on a rank, 6.71e7, and the second's
    Partial sum is reduced by one all-reduce of the rank's (16, 4096) f32
    block, 262,144 bytes, over a "model" group of 16 ranks (two nodes:
    the network); the wait is not counted."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake_16x16
    x = _meta_dtensor(mesh, (256, 4096), [Shard(0), Replicate()])
    w1 = _meta_dtensor(mesh, (4096, 8192), [Replicate(), Shard(1)])
    w2 = _meta_dtensor(mesh, (8192, 4096), [Replicate(), Shard(0)])

    def step():
        y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
        return torch.ops._c10d_functional.wait_tensor(y.to_local())

    out, t = oa.analyze(step)
    assert tuple(out.shape) == (16, 4096)
    per_mm = 2 * 256 * 4096 * 8192 / 256
    assert per_mm == pytest.approx(6.71e7, rel=1e-3)
    mms = [(k, v) for k, v in t.by_op.items() if k[1] == "aten.mm"]
    assert sum(v[0] for _, v in mms) == 2
    assert t.flops == 2 * per_mm
    assert t.coll_bytes == {"all-reduce": 262144.0, "total": 262144.0}
    assert t.coll_link_bytes == {"network": 262144.0}
    assert not any("wait_tensor" in k[1] for k in t.by_op)
    # the mm operands and outputs are the local blocks: (16, 4096) @
    # (4096, 512) -> (16, 512) and (16, 512) @ (512, 4096) -> (16, 4096)
    want = 4 * (16 * 4096 + 4096 * 512 + 16 * 512
                + 16 * 512 + 512 * 4096 + 16 * 4096)
    assert sum(v[1] for _, v in mms) == want


def test_op_counter_matches_flop_counter_on_one_device():
    """A plain one-device train step of the stablelm smoke config: the
    op counter's FLOPs equal ``FlopCounterMode``'s total, forward and
    backward."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.steps import loss_and_grads
    cfg = get_config("stablelm_1_6b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    with FlopCounterMode(display=False) as fc:
        loss_and_grads(params, cfg, batch)
    (loss, _), t = oa.analyze(loss_and_grads, params, cfg, batch)
    assert t.flops == fc.get_total_flops() > 0
    assert math.isfinite(float(loss))
    assert t.hbm_bytes > 0 and t.coll_bytes == {"total": 0}
    assert any(g.startswith("bwd:") for g in t.flops_by_group)
    assert "attention._attend_block" in t.flops_by_group


def test_op_counter_counts_every_unit():
    """The eager forward runs every unit: the smoke config's FLOPs grow
    with its units as >~2*N*D, the property the JAX module's loop-aware
    HLO count exists for (test_launch.py)."""
    import dataclasses
    cfg = get_config("stablelm_1_6b", smoke=True)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device="meta")
    flops = {}
    for units in (1, 2, 3):
        c = dataclasses.replace(cfg, stages=tuple(
            dataclasses.replace(st, n_units=units) for st in cfg.stages))
        params = T.init_params(c, device="meta")
        _, t = oa.analyze(T.forward, params, c, tokens=tokens, mode="train")
        flops[units] = t.flops
        assert t.flops > 1.5 * T.count_params(c) * tokens.numel() / 2
    block = flops[2] - flops[1]
    assert block > 0 and flops[3] - flops[2] == block


#: (what, step on x (4, 8) f32, y (4, 8) f32, m (8, 2) f32, table (16, 8)
#: f32, idx 2 int64; the aten ops counted, bytes, FLOPs): 128 bytes an
#: x or y, 64 an m, 32 a (4, 2) product, 64 two table rows, 16 the idx
BYTE_RULES = [
    ("view", lambda x, y, m, tb, i: x.view(8, 4), 0, 0, 0),
    ("transpose", lambda x, y, m, tb, i: x.t(), 0, 0, 0),
    ("detach", lambda x, y, m, tb, i: x.detach(), 0, 0, 0),
    ("empty_like", lambda x, y, m, tb, i: torch.empty_like(x), 0, 0, 0),
    ("contiguous of a contiguous", lambda x, y, m, tb, i: x.contiguous(),
     0, 0, 0),
    ("add", lambda x, y, m, tb, i: x + y, 1, 3 * 128, 0),
    ("in-place add", lambda x, y, m, tb, i: x.add_(y), 1, 3 * 128, 0),
    ("copy of a transpose", lambda x, y, m, tb, i: x.t().contiguous(), 1,
     2 * 128, 0),
    ("clone", lambda x, y, m, tb, i: x.clone(), 1, 2 * 128, 0),
    ("cast to bf16", lambda x, y, m, tb, i: x.to(torch.bfloat16), 1,
     128 + 64, 0),
    ("row sum", lambda x, y, m, tb, i: x.sum(-1), 1, 128 + 16, 0),
    ("matmul", lambda x, y, m, tb, i: x @ m, 1, 128 + 64 + 32,
     2 * 4 * 8 * 2),
    ("index_select", lambda x, y, m, tb, i: tb.index_select(0, i), 1,
     2 * 64 + 16, 0),
    ("embedding", lambda x, y, m, tb, i: torch.nn.functional.embedding(
        i, tb), 1, 2 * 64 + 16, 0),
]


@pytest.mark.parametrize("what,step,ops,nbytes,flops", BYTE_RULES,
                         ids=[r[0] for r in BYTE_RULES])
def test_op_counter_byte_rules(what, step, ops, nbytes, flops):
    """Each byte rule of the module docstring on one op, by hand: a view,
    an alias, an allocation and a copy that copies nothing are free; an
    elementwise op, a copy and a cast read each operand and write the
    output once, an in-place op too; a gather reads the rows it returns
    and its indices, not its table."""
    gen = torch.Generator().manual_seed(0)
    x, y = torch.randn(4, 8, generator=gen), torch.randn(4, 8, generator=gen)
    m, tb = torch.randn(8, 2, generator=gen), torch.randn(16, 8, generator=gen)
    idx = torch.tensor([3, 11])
    _, t = oa.analyze(step, x, y, m, tb, idx)
    assert (t.ops, t.hbm_bytes, t.flops) == (ops, nbytes, flops), t.by_op
