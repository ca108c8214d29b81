"""The port's SSD pieces against the JAX package's, on the CPU: the
``ssd_chunk`` kernel's plain version against the Pallas kernel in
interpret mode and the ``ref`` oracle, the bf16 kernel's arithmetic (the
``hi + lo`` split) emulated at one mamba2-130m chunk against both, its
launch rule, the chunked mixer (ragged S, groups, an initial state), the
chunked form against the decode recurrence, and the depthwise causal
conv.  Inputs are numpy draws from a seed, fed to both packages."""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from _torch_parity import assert_close, t                       # noqa: E402
from repro.kernels import ref as j_ref                          # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as j_ssd_chunk    # noqa: E402
from repro.models import ssm as j_ssm                           # noqa: E402
from repro_torch.kernels import ref                             # noqa: E402
from repro_torch.kernels import ssd_chunk as sc                 # noqa: E402
from repro_torch.models import ssm                              # noqa: E402

#: f32 both sides, the same terms summed in another order: relative to
#: max|y| (and max|S| for the states)
RTOL = 1e-5
#: a bf16 y against an f32 reference on the same values: one bf16
#: rounding (2**-8 of the value) plus the f32 summation order
BF16_RTOL = 2.0 ** -8 + RTOL
#: mamba2-130m's mixer: (H, P, G, N), chunk
MAMBA = (24, 64, 1, 128), 256
#: (B, S, H, P, G, N), L of the card tests (tests/test_torch_cuda.py)
EDGE_SHAPES = [
    ((2, 128, 4, 16, 4, 8), 128), ((2, 128, 4, 16, 4, 8), 32),
    ((1, 512, 4, 64, 1, 128), 256), ((2, 100, 3, 32, 1, 16), 100),
    ((1, 256, 4, 128, 2, 256), 128), ((2, 96, 6, 40, 3, 24), 48)]


def _inputs(rng, b, s, h, p, g, n):
    """The JAX kernel test's distributions: dt > 0 small, a_log ~ 0."""
    return (rng.randn(b, s, h, p).astype(np.float32),
            (np.abs(rng.randn(b, s, h)) * 0.1 + 0.05).astype(np.float32),
            (rng.randn(h) * 0.3).astype(np.float32),
            (rng.randn(b, s, g, n) * 0.3).astype(np.float32),
            (rng.randn(b, s, g, n) * 0.3).astype(np.float32))


@pytest.mark.parametrize("chunk", [128, 32])
def test_ssd_chunk_plain_matches_pallas(chunk):
    """test_kernels.py's shape, B and C pre-repeated over heads (G == H,
    the TPU kernel's signature)."""
    x, dt, a_log, b, c = _inputs(np.random.RandomState(0), 2, 128, 4, 16,
                                 4, 8)
    y_j, s_j = j_ssd_chunk(*(jnp.asarray(a) for a in (x, dt, a_log, b, c)),
                           chunk=chunk, interpret=True)
    y, s = sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)
    for i in range(128 // chunk):               # each chunk vs the oracle
        sl = slice(chunk * i, chunk * (i + 1))
        want = j_ref.ssd_intra_chunk_ref(
            *(jnp.asarray(a[:, sl]) for a in (x, dt)), jnp.asarray(a_log),
            *(jnp.asarray(a[:, sl]) for a in (b, c)))
        got = ref.ssd_intra_chunk_ref(*(t(a[:, sl]) for a in (x, dt)),
                                      t(a_log), *(t(a[:, sl]) for a in (b, c)))
        assert_close(got, np.asarray(want), RTOL)


def test_ssd_chunk_groups_read_in_place():
    """(B,S,G,N) with G < H computes the pre-repeated function."""
    x, dt, a_log, b, c = _inputs(np.random.RandomState(1), 2, 64, 4, 8, 2, 8)
    y, s = sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=32)
    rep = [np.repeat(a, 2, axis=2) for a in (b, c)]
    y_j, s_j = j_ssd_chunk(*(jnp.asarray(a) for a in (x, dt, a_log, *rep)),
                           chunk=32, interpret=True)
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)


def test_ssd_chunk_refuses_ragged_seq():
    x, dt, a_log, b, c = _inputs(np.random.RandomState(2), 1, 40, 2, 8, 1, 4)
    with pytest.raises(ValueError, match="chunk"):
        sc.ssd_chunk(*(t(a) for a in (x, dt, a_log, b, c)), chunk=32)


def test_segsum_matches_jax():
    a = np.random.RandomState(3).randn(2, 3, 9).astype(np.float32)
    got, want = ssm.segsum(t(a)).numpy(), np.asarray(j_ssm.segsum(
        jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,g,chunk,with_state", [
    (96, 1, 32, False),            # three whole chunks
    (100, 1, 32, False),           # ragged: padded with dt = 0 tokens
    (20, 1, 32, False),            # shorter than a chunk: L = S
    (70, 2, 16, True),             # G = 2 of H = 4, an initial state
])
def test_ssd_chunked_matches_jax(s, g, chunk, with_state):
    rng = np.random.RandomState(4)
    h, p, n = 4, 8, 16
    x, dt, a_log, b, c = _inputs(rng, 2, s, h, p, g, n)
    d = rng.randn(h).astype(np.float32)
    h0 = (rng.randn(2, h, p, n) * 0.5).astype(np.float32) \
        if with_state else None
    cfg_j = j_ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                            n_groups=g, chunk=chunk)
    cfg_t = ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                          n_groups=g, chunk=chunk)
    y_j, st_j = j_ssm.ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c, d)), cfg_j,
        init_state=None if h0 is None else jnp.asarray(h0))
    y, st = ssm.ssd_chunked(*(t(a) for a in (x, dt, a_log, b, c, d)), cfg_t,
                            init_state=None if h0 is None else t(h0))
    assert y.shape == (2, s, h, p) and st.shape == (2, h, p, n)
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(st, np.asarray(st_j), RTOL)


def test_ssd_chunked_matches_decode_recurrence():
    """The chunked form equals the token-by-token recurrence of
    ``ssd_decode_step`` (both in the port), as the JAX test checks."""
    rng = np.random.RandomState(1)
    bsz, s, h, p, g, n = 2, 64, 4, 8, 1, 16
    cfg = ssm.SSMConfig(d_inner=h * p, n_heads=h, head_dim=p, d_state=n,
                        n_groups=g, chunk=16)
    x, dt, a_log, b, c = (t(a) for a in _inputs(rng, bsz, s, h, p, g, n))
    d = t(rng.randn(h).astype(np.float32))
    y_chunk, st_chunk = ssm.ssd_chunked(x, dt, a_log, b, c, d, cfg)
    st = torch.zeros(bsz, h, p, n)
    ys = []
    for i in range(s):
        y1, st = ssm.ssd_decode_step(x[:, i:i + 1], dt[:, i:i + 1], a_log,
                                     b[:, i:i + 1], c[:, i:i + 1], d, st)
        ys.append(y1)
    assert_close(y_chunk, torch.cat(ys, 1).numpy(), RTOL)
    assert_close(st_chunk, st.numpy(), RTOL)


def test_ssd_decode_step_matches_jax():
    rng = np.random.RandomState(5)
    x, dt, a_log, b, c = _inputs(rng, 2, 1, 4, 8, 2, 16)
    d = rng.randn(4).astype(np.float32)
    st = rng.randn(2, 4, 8, 16).astype(np.float32)
    y_j, s_j = j_ssm.ssd_decode_step(
        *(jnp.asarray(a) for a in (x, dt, a_log, b, c, d, st)))
    y, s = ssm.ssd_decode_step(*(t(a) for a in (x, dt, a_log, b, c, d, st)))
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(s, np.asarray(s_j), RTOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    """The weights are cast to bf16 in both packages, the input stays
    f32: the same products, summed in the same order."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 11, 24).astype(np.float32)
    w = rng.randn(4, 24).astype(np.float32)
    st = rng.randn(2, 3, 24).astype(np.float32) if with_state else None
    y_j, n_j = j_ssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    y, n = ssm.causal_conv1d(t(x), t(w), None if st is None else t(st))
    assert_close(y, np.asarray(y_j), RTOL)
    assert_close(n, np.asarray(n_j), 0.0)


def _bf16(a):
    """numpy f32 -> the same values rounded to bf16, as f32 numpy."""
    return t(a).to(torch.bfloat16).float().numpy()


def _split(v):
    """f32 -> (hi, lo) bf16 values (as f32): hi = bf16(v), lo = bf16(v -
    hi), the kernel's split of its f32 operand."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _split3(v):
    """f32 -> (hi, mid, lo) bf16 values (as f32), the kernel's split of
    the state product's f32 operand: hi + mid + lo within 2**-27."""
    hi, mid = _split(v)
    return hi, mid, (v - hi - mid).to(torch.bfloat16).float()


def _emulate_bf16_kernel(x, dt, a_log, b, c, chunk, state_terms=3):
    """The bf16 kernel's arithmetic, written out in f32 torch: C . B^T
    from the bf16 inputs (exact products, f32 sums) once per group; w =
    C.B^T exp(cs_i - cs_j) dt_j in f32, masked before the exponential,
    split into bf16 hi + lo and multiplied by x in bf16 with f32 sums;
    the state's x dt exp(cs_end - cs_j) split into ``state_terms`` bf16
    terms (the kernel's three, or two) against the exact B.  Returns (y
    before and after its bf16 rounding, states)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc, rep = s // chunk, h // g
    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b.reshape(bsz, nc, chunk, g, n)
    cr = c.reshape(bsz, nc, chunk, g, n)
    cs = torch.cumsum(dtr * -torch.exp(a_log), 2).movedim(-1, 2)
    cb = torch.einsum("bnigs,bnjgs->bngij", cr, br)          # per group
    cb = cb.repeat_interleave(rep, dim=2)                     # (B,nc,H,L,L)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    w = torch.where(mask, cb * torch.exp(torch.where(mask, seg, 0.0))
                    * dtr.movedim(-1, 2)[..., None, :], 0.0)
    hi, lo = _split(w)
    y = (torch.einsum("bnhij,bnjhp->bnihp", hi, xr)
         + torch.einsum("bnhij,bnjhp->bnihp", lo, xr)).reshape(x.shape)
    scale = dtr * torch.exp(cs.movedim(2, -1)[:, :, -1:] - cs.movedim(2, -1))
    v = xr * scale[..., None]
    terms = _split3(v) if state_terms == 3 else _split(v)
    bh = br.repeat_interleave(rep, dim=3)
    st = sum(torch.einsum("bnjhp,bnjhs->bnhps", term, bh) for term in terms)
    return y, y.to(torch.bfloat16), st


@pytest.mark.parametrize("state_terms", [2, 3])
def test_bf16_split_arithmetic_at_a_mamba_chunk(state_terms):
    """One mamba2-130m chunk (B 1, S 256, H 24, P 64, G 1, N 128) in bf16:
    the kernel's split arithmetic against the JAX kernel in interpret
    mode (B and C pre-repeated over heads) and ssd_chunk_plain, both f32
    on the same bf16 values.  y within one bf16 rounding of max|y| (and
    within RTOL before that rounding: the split's 2**-18 stays below the
    f32 gate), the states within RTOL of max|S| with the state operand
    split in two (hi + lo) and in three (the kernel's)."""
    (h, p, g, n), chunk = MAMBA
    x, dt, a_log, b, c = _inputs(np.random.RandomState(7), 1, chunk, h, p,
                                 g, n)
    x, dt, b, c = (_bf16(a) for a in (x, dt, b, c))
    y_raw, y_bf, st = _emulate_bf16_kernel(
        *(t(a) for a in (x, dt, a_log, b, c)), chunk, state_terms)
    rep = [np.repeat(a, h // g, axis=2) for a in (b, c)]
    y_j, s_j = j_ssd_chunk(*(jnp.asarray(a) for a in (x, dt, a_log, *rep)),
                           chunk=chunk, interpret=True)
    y_p, s_p = sc.ssd_chunk_plain(*(t(a) for a in (x, dt, a_log, b, c)),
                                  chunk=chunk)
    for want_y, want_s in ((np.asarray(y_j), np.asarray(s_j)),
                           (y_p.numpy(), s_p.numpy())):
        assert_close(y_bf.float(), want_y, BF16_RTOL)
        assert_close(y_raw, want_y, RTOL)
        assert_close(st, want_s, RTOL)


#: the SMs of an H100 SXM, for the launch rule
SMS = 132


@pytest.mark.parametrize("shape,chunk", EDGE_SHAPES + [
    ((4, 2048) + MAMBA[0][:2] + MAMBA[0][2:], MAMBA[1])])
def test_ssd_launch_dims_cover_every_head_once(shape, chunk):
    """Every width the rule may take: the slices cover each group's
    heads once, the blocks are (batch * chunk) x (G x slices x query
    tiles + H), one work per block in launch order, and the layout fits
    in shared memory; the rule's own choice is one of them."""
    bsz, s, h, p, g, n = shape
    rep, n_qt = h // g, math.ceil(chunk / sc.QUERY_ROWS)
    chosen = sc.ssd_launch_dims(bsz, s, h, p, g, n, chunk, SMS)
    taken = []
    for w in sc.SLICE_HEADS:
        try:
            lay = sc.ssd_launch_dims(bsz, s, h, p, g, n, chunk, SMS,
                                     slice_heads=w)
        except ValueError:
            continue
        taken.append(lay)
        sizes = [min(w, rep - k) for k in range(0, rep, w)]
        assert lay.heads == w and lay.slices == len(sizes)
        assert sum(sizes) == rep and min(sizes) >= 1
        assert w * sc.acc_tiles(p) <= sc.MAX_ACC_TILES
        assert lay.smem == sc.ssd_smem_bytes(w, chunk, p, n) <= 227 * 1024
        assert lay.blocks == bsz * (s // chunk) * (g * lay.slices * n_qt + h)
        assert len(sc.launch_works(bsz, s, h, p, g, n, chunk, w,
                                   lay.state_level)) == lay.blocks
    assert chosen in taken and taken


@pytest.mark.parametrize("shape,chunk", EDGE_SHAPES + [
    ((4, 2048) + MAMBA[0][:2] + MAMBA[0][2:], MAMBA[1])])
def test_ssd_launch_order_is_heavy_first(shape, chunk):
    """Query tiles start last to first and the state blocks sit between
    the levels of heavier and of lighter y blocks."""
    bsz, s, h, p, g, n = shape
    lay = sc.ssd_launch_dims(bsz, s, h, p, g, n, chunk, SMS)
    works = sc.launch_works(bsz, s, h, p, g, n, chunk, lay.heads,
                            lay.state_level)
    state = sc.block_work(chunk, p, n, 0, 0)
    n_state = bsz * (s // chunk) * h
    first = lay.state_level * (lay.blocks - n_state) // math.ceil(
        chunk / sc.QUERY_ROWS)
    assert works[first:first + n_state] == [state] * n_state
    y = works[:first] + works[first + n_state:]
    per_level = len(y) // math.ceil(chunk / sc.QUERY_ROWS)
    tops = [max(y[k:k + per_level]) for k in range(0, len(y), per_level)]
    assert tops == sorted(tops, reverse=True)
    assert all(top >= state for top in tops[:lay.state_level])
    assert all(top < state for top in tops[lay.state_level:])


def test_ssd_launch_dims_at_mamba_and_at_g_equal_h():
    """mamba2-130m's prefill (B 4, S 2048, L 256: 32 chunks, 2 query
    tiles, 24 heads in one group: the scores shared by 2 heads, the
    widest slice whose y accumulators fit at P 64) and the JAX test's
    G == H shape (one head a group: one head a block)."""
    (h, p, g, n), chunk = MAMBA
    lay = sc.ssd_launch_dims(4, 2048, h, p, g, n, chunk, SMS)
    assert (lay.heads, lay.slices) == (2, 12)
    assert lay.blocks == 32 * (12 * 2 + h)
    for chunk in (128, 32):
        lay = sc.ssd_launch_dims(2, 128, 4, 16, 4, 8, chunk, SMS)
        assert (lay.heads, lay.slices) == (1, 1)
        assert lay.blocks == 2 * (128 // chunk) * (4 * math.ceil(
            chunk / sc.QUERY_ROWS) + 4)


def test_ssd_launch_dims_refuse_widths_without_an_instance():
    with pytest.raises(ValueError, match="heads a block"):
        sc.ssd_launch_dims(1, 256, 4, 128, 1, 128, 128, SMS,
                           slice_heads=2)         # 2 x 16 tiles > 16
    with pytest.raises(ValueError, match="heads a block"):
        sc.ssd_launch_dims(1, 256, 4, 64, 4, 128, 128, SMS,
                           slice_heads=2)         # one head a group


def test_ssd_launch_dims_mirror_the_source():
    """The rule's constants and instances are the source's."""
    src = (Path(sc.__file__).resolve().parents[1] / "csrc"
           / sc.SOURCE).read_text()
    tc = src[src.index("namespace tc {"):]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", tc).group(1))
    assert (const("T"), const("TQ"), const("PAD"), const("NB"),
            const("SD")) == (sc.TILE, sc.QUERY_ROWS, sc.PAD, sc.STATE_COLS,
                             sc.STATE_SLOTS)
    inst = set(re.findall(r"SSD_TC\((\d+), (\d+)\)", tc))
    want = {(str(k), str(w)) for k in sc.ACC_TILES for w in sc.SLICE_HEADS
            if k * w <= sc.MAX_ACC_TILES}
    assert inst == want


def test_vector_staging():
    x = torch.zeros(2, 64, 4, 64, dtype=torch.bfloat16)
    b = torch.zeros(2, 64, 1, 128, dtype=torch.bfloat16)
    assert sc.vector_staging(x, b, b)
    proj = torch.zeros(2, 64, 4 * 64 + 256, dtype=torch.bfloat16)
    xv = proj[..., :256].reshape(2, 64, 4, 64)
    bv = proj[..., 256:384].reshape(2, 64, 1, 128)
    assert sc.vector_staging(xv, bv, bv)
    odd = torch.zeros(2, 64, 1, 24 + 1, dtype=torch.bfloat16)[..., 1:]
    assert not sc.vector_staging(x, odd, b)
    assert not sc.vector_staging(x[..., :60], b, b)


def test_kernel_entries_refuse_tensors_without_storage():
    """``_build.ptr`` (every kernel entry's operands) and the three
    ``vector_staging`` probes refuse, naming the operand, a ``meta``
    tensor (address 0) and a ``DTensor`` (a wrapper without storage of
    its own, ``data_ptr()`` 0); an empty tensor and a CPU tensor pass."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import tetris_matmul as tm
    from repro_torch.launch import dryrun
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(TypeError, match="x .*no storage"):
        _build.ptr(meta, "x")
    assert _build.ptr(torch.empty(0, device="meta"), "e").value is None
    cpu = torch.ones(3)
    assert _build.ptr(cpu, "w").value == cpu.data_ptr()
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        wrapped = DTensor.from_local(cpu, mesh, [Replicate()] * 2)
        assert wrapped.data_ptr() == 0
        with pytest.raises(TypeError, match="q is a DTensor"):
            _build.ptr(wrapped, "q")
        for probe in (tm.vector_staging, fa.vector_staging,
                      sc.vector_staging):
            with pytest.raises(TypeError, match="operand 1 is a DTensor"):
                probe(cpu, wrapped)
    for probe in (tm.vector_staging, fa.vector_staging, sc.vector_staging):
        with pytest.raises(TypeError, match="operand 0 .*no storage"):
            probe(meta)


def _dtensors(mesh, args, placements):
    """``args`` (x, dt, a_log, b, c) as DTensors on a world-1 mesh, x and
    dt by ``placements``, the rest replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    return tuple(DTensor.from_local(a, mesh, placements if i < 2 else rep)
                 for i, a in enumerate(args))


@pytest.mark.parametrize("placements", ["S0,S2", "R,R"])
def test_ssd_chunk_on_dtensors_runs_on_local_shards(placements,
                                                    monkeypatch):
    """On a world-1 CPU mesh (a fake group) ``ssd_chunk`` on DTensors runs
    the local-shard route, the plain version on each rank's shards,
    bitwise the plain version on plain tensors, y on x's placements and
    the states on the same splits; on ``meta`` DTensors (the dry run) it
    keeps the plain version's DTensor ops and never reaches the route."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    pl = {"S0,S2": [Shard(0), Shard(2)], "R,R": [Replicate()] * 2}[
        placements]
    args = [torch.tensor(a) for a in _inputs(np.random.RandomState(0),
                                             2, 64, 4, 16, 2, 8)]
    y0, s0 = sc.ssd_chunk_plain(*args, chunk=32)
    calls = []
    route = sc.ssd_chunk_local
    monkeypatch.setattr(sc, "ssd_chunk_local",
                        lambda *a, **k: calls.append(1) or route(*a, **k))
    with dryrun.fake_group(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        y, s = sc.ssd_chunk(*_dtensors(mesh, args, pl), chunk=32)
        assert calls == [1]
        assert isinstance(y, DTensor) and list(y.placements) == pl
        assert list(s.placements) == pl and s.shape == s0.shape
        assert torch.equal(y.to_local(), y0) and torch.equal(s.to_local(), s0)
        metas = [a.to("meta") for a in args]
        with sh.spmd(mesh):
            ym, sm = sc.ssd_chunk(*_dtensors(mesh, metas, pl), chunk=32)
        assert calls == [1]
        assert ym.device.type == "meta" and ym.shape == y0.shape
        assert sm.shape == s0.shape


@pytest.mark.parametrize("given, mesh_shape, shape, want", [
    # batch over "data", heads over "model": kept (one group, 2 heads a
    # rank; then whole groups)
    ("S0,S2", (2, 2), (4, 24, 1), "S0,S2"),
    ("S0,S2", (2, 2), (4, 24, 12), "S0,S2"),
    # heads straddle a group (6 heads in 3 groups, 3 a rank): gathered
    ("S0,S2", (2, 2), (4, 6, 3), "S0,R"),
    # uneven batch (3 over 2), uneven heads (6 over 4): gathered
    ("S0,S2", (2, 2), (3, 8, 1), "R,S2"),
    ("S2,S2", (2, 2), (4, 6, 1), "R,R"),
    ("S2,S2", (2, 2), (4, 8, 1), "S2,S2"),
    # a Partial, a sequence split and a split of P: made whole
    ("P,S2", (2, 2), (4, 8, 1), "R,S2"),
    ("S1,S0", (2, 2), (4, 8, 1), "R,S0"),
    ("S3,R", (2, 2), (4, 8, 1), "R,R"),
])
def test_local_placements(given, mesh_shape, shape, want):
    """What the local-shard route keeps of x's placements: even splits of
    the batch and of the heads (whole groups, or one group a rank)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = {"S0": Shard(0), "S1": Shard(1), "S2": Shard(2),
             "S3": Shard(3), "R": Replicate(), "P": Partial()}
    batch, heads, groups = shape
    got = sc.local_placements([names[n] for n in given.split(",")],
                              mesh_shape, batch, heads, groups)
    assert got == [names[n] for n in want.split(",")]


def test_mamba2_train_cell_on_a_mesh_without_dtensor_flip():
    """mamba2's train cell (smoke, 2 units) on DTensors over a world-1
    CPU mesh (a fake group) runs where DTensor has no strategy for
    ``aten.flip`` (the card's torch 2.11, which refused cumsum's backward
    there), through ``ssd_chunk.cumsum``'s local backward, and equals the
    cell on plain tensors bitwise: the loss, the gradient norm and every
    new param and moment."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from _torch_lm_mesh import without_flip_strategy
    from repro_torch.checkpoint.store import _flatten
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch import mesh as meshlib
    cfg = get_config("mamba2_130m", smoke=True)
    spec = shapes.ShapeSpec("smoke_train", 32, 2, "train")
    outs = []
    with dryrun.fake_group(1), without_flip_strategy():
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.ones(2, 3), mesh, [Shard(0)] * 2)
        with pytest.raises(NotImplementedError, match="flip"):
            x.flip(1)
        for m in (mesh, meshlib.make_host_mesh("cpu")):
            fn, args, ins, _ = shapes.build_cell(cfg, spec, m,
                                                 microbatches=1)
            outs.append(_flatten(fn(*shapes.materialize(cfg, spec, args,
                                                        ins))))
    assert [k for k, _ in outs[0]] == [k for k, _ in outs[1]]
    for (key, a), (_, b) in zip(*outs):
        assert isinstance(a, DTensor), key
        assert torch.equal(a.to_local(), b), key
