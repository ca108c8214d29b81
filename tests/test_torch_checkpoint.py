"""The port's checkpoints, data pipeline, fault-tolerance supervisor and
gradient compression: counterparts of tests/test_checkpoint.py's cases
(its mesh cases, elastic resharding and derive_elastic_mesh, wait for
meshes), then against the JAX package: ``TokenStream`` batches and the
int8 compression bit for bit, checkpoints restoring across the two
packages in both directions, the supervisor's crash and resume
restart-exact on a real model, and ``launch.train --arch`` with and
without ``--resume``."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch                                                    # noqa: E402

from repro import checkpoint as j_checkpoint                    # noqa: E402
from repro import optim as j_optim                              # noqa: E402
from repro.configs import get_config as j_get_config            # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream    # noqa: E402
from repro.launch import steps as j_steps                       # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401 (autouse)
from repro_torch.checkpoint import (CheckpointStore,            # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import ShardedDataPipeline, TokenStream   # noqa: E402
from repro_torch.launch import steps, train                     # noqa: E402
from repro_torch.optim import (compress_int8, compress_pytree,  # noqa: E402
                               decompress_int8, ef_compress_update,
                               tree_leaves, tree_map)
from repro_torch.runtime import (HeartbeatMonitor,              # noqa: E402
                                 StragglerPolicy, TrainSupervisor)
from repro_torch.runtime.recovery import WorkerLost             # noqa: E402

#: smoke configs whose train states cross between the packages: the
#: attention family, the SSD mixer, an encoder-decoder (enc_stages)
CROSS = ("stablelm_1_6b", "mamba2_130m", "whisper_base")


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 8), generator=g),
                       "b": torch.zeros((8,))},
            "opt": {"m": torch.ones((8, 8)),
                    "step": torch.tensor(3, dtype=torch.int32)}}


def _meta(state):
    return tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                          device="meta"), state)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _manifest(path):
    return json.loads((path / "MANIFEST.json").read_text())


# --- counterparts of tests/test_checkpoint.py ----------------------------

def test_save_restore_roundtrip(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 7, s, extra={"data_step": 7})
    r, step, extra = restore_checkpoint(tmp_path, _meta(s), device="cpu")
    assert step == 7 and extra["data_step"] == 7
    _equal(r, s)
    assert latest_step(tmp_path) == 7
    assert not list(tmp_path.glob("*.tmp"))


def test_store_keeps_last_k(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        store.save(step, _state())
    steps_ = sorted(p.name for p in tmp_path.iterdir())
    assert steps_ == ["step_00000003", "step_00000004"]


def test_async_save(tmp_path):
    store = CheckpointStore(tmp_path, keep=2, async_save=True, device="cpu")
    store.save(5, _state())
    store.wait()
    r, step, _ = store.restore_latest(_meta(_state()))
    assert step == 5
    _equal(r, _state())


def test_async_save_snapshots_before_returning(tmp_path):
    """``.cpu()`` of a CPU tensor is the tensor itself: the snapshot must
    be a copy, or a step that updates the state in place while the worker
    writes would reach the file."""
    s = _state()
    want = tree_map(torch.clone, s)
    store = CheckpointStore(tmp_path, async_save=True, device="cpu")
    store.save(1, s)
    for a in tree_leaves(s):
        a.add_(1)
    store.wait()
    _equal(restore_checkpoint(tmp_path, _meta(s), device="cpu")[0], want)


def test_data_pipeline_restart_exact():
    ts = TokenStream(vocab=100, seq_len=16, global_batch=4, seed=1)
    p1 = ShardedDataPipeline(ts, shard=0, n_shards=2)
    seq = [p1.next() for _ in range(5)]
    p2 = ShardedDataPipeline(ts, shard=0, n_shards=2)
    p2.skip_to(3)
    np.testing.assert_array_equal(p2.next(), seq[3])
    np.testing.assert_array_equal(p2.next(), seq[4])
    p3 = ShardedDataPipeline(ts, shard=0, n_shards=2)
    p3.skip_to(1)
    p3.start()
    try:
        got = [p3.next_prefetched() for _ in range(3)]
    finally:
        p3.stop()
    for a, b in zip(got, seq[1:4]):
        np.testing.assert_array_equal(a, b)
    assert p3.step == 4


def test_supervisor_failure_and_resume(tmp_path):
    """Train, crash mid-run, resume from the checkpoint, finish: the
    final state equals an uninterrupted run's."""
    ts = TokenStream(vocab=50, seq_len=8, global_batch=2, seed=0)

    def step_fn(state, batch):
        s = state["sum"] + float(batch.sum())
        return {"sum": s, "n": state["n"] + 1}, {}

    def fresh():
        return {"sum": torch.tensor(0.0, dtype=torch.float64),
                "n": torch.tensor(0)}

    ref = TrainSupervisor(store=CheckpointStore(tmp_path / "ref"),
                          pipeline=ShardedDataPipeline(ts),
                          monitor=HeartbeatMonitor(1), save_every=5)
    ref_state, _ = ref.run(fresh(), step_fn, steps=20)

    store = CheckpointStore(tmp_path / "ckpt", device="cpu")
    sup = TrainSupervisor(store=store, pipeline=ShardedDataPipeline(ts),
                          monitor=HeartbeatMonitor(1), save_every=5)
    with pytest.raises(WorkerLost):
        sup.run(fresh(), step_fn, steps=20, inject_failure_at=12)
    sup2 = TrainSupervisor(store=store, pipeline=ShardedDataPipeline(ts),
                           monitor=HeartbeatMonitor(1), save_every=5)
    state, last = sup2.resume(_meta(fresh()), step_fn, steps=20)
    assert last == 20
    assert float(state["sum"]) == float(ref_state["sum"])
    assert int(state["n"]) == 20
    assert any("resumed from step 10" in e for e in sup2.events)


def test_straggler_detection():
    clock = [0.0]
    mon = HeartbeatMonitor(3, dead_after_s=10,
                           policy=StragglerPolicy(window=4),
                           clock=lambda: clock[0])
    for _ in range(4):
        mon.report(0, 1.0)
        mon.report(1, 1.0)
        mon.report(2, 5.0)       # slow worker
    assert mon.stragglers().get(2) in ("warn", "demote")
    clock[0] = 100.0
    assert set(mon.dead_workers()) == {0, 1, 2}


def test_gradient_compression_error_feedback():
    """The accumulated update converges to the true gradient sum (error
    feedback), and the payload is int8."""
    rng = np.random.RandomState(0)
    true_sum = np.zeros(256, np.float32)
    applied_sum = np.zeros(256, np.float32)
    residual = torch.zeros(256)
    for _ in range(50):
        g = torch.as_tensor((rng.randn(256) * (1 + 10 * rng.rand()))
                            .astype(np.float32))
        q, scale, residual = ef_compress_update(g, residual)
        applied_sum += decompress_int8(q, scale).numpy()
        true_sum += g.numpy()
    np.testing.assert_allclose(applied_sum + residual.numpy(), true_sum,
                               rtol=1e-5, atol=1e-3)
    q, _ = compress_int8(torch.ones(1024))
    assert q.dtype == torch.int8


# --- against the JAX package ---------------------------------------------

def test_token_stream_matches_jax():
    for vocab, seq, batch, seed in ((100, 16, 4, 1), (50304, 33, 8, 7)):
        j = JTokenStream(vocab=vocab, seq_len=seq, global_batch=batch,
                         seed=seed)
        t = TokenStream(vocab=vocab, seq_len=seq, global_batch=batch,
                        seed=seed)
        for step in (0, 1, 9, 123):
            for shard, n in ((0, 1), (0, 2), (1, 2), (3, 4)):
                a, b = j.batch_at(step, shard, n), t.batch_at(step, shard, n)
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)


def test_compression_matches_jax():
    """compress_int8, ef_compress_update over 20 steps (with values that
    round half way) and compress_pytree give the JAX package's bits."""
    rng = np.random.RandomState(3)
    res_j, res_t = jnp.zeros(512, jnp.float32), torch.zeros(512)
    for i in range(20):
        g = (rng.randn(512) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
        if i == 0:
            g[:4] = [127.0, -63.5, 0.5, -1.5]     # exact halves of scale 1
        qj, sj, res_j = j_optim.ef_compress_update(jnp.asarray(g), res_j)
        qt, st, res_t = ef_compress_update(torch.as_tensor(g), res_t)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.numpy().tobytes() == np.asarray(sj).tobytes()
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": (rng.randn(7).astype(np.float32),)}
    zeros = tree_map(lambda a: torch.zeros(a.shape),
                     tree_map(torch.as_tensor, tree))
    out_t = compress_pytree(tree_map(torch.as_tensor, tree), zeros)
    out_j = j_optim.compression.compress_pytree(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(lambda a: jnp.zeros(a.shape), tree))
    for ot, oj in zip(out_t, out_j):
        for a, b in zip(tree_leaves(ot), jax.tree.leaves(oj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", CROSS)
def test_jax_checkpoint_restores_in_port(arch, tmp_path):
    """A smoke train state saved by ``repro.checkpoint`` restores in the
    port into ``init_train_state(cfg, None, "meta")`` bit for bit, and the
    port writes the same MANIFEST for it."""
    sj = j_steps.init_train_state(j_get_config(arch, smoke=True),
                                  jax.random.PRNGKey(0))
    j_checkpoint.save_checkpoint(tmp_path / "jax", 3, sj,
                                 extra={"data_step": 3})
    cfg = get_config(arch, smoke=True)
    st, step, extra = restore_checkpoint(
        tmp_path / "jax", steps.init_train_state(cfg, None, "meta"),
        device="cpu")
    assert step == 3 and extra == {"data_step": 3}
    leaves_j = jax.tree.leaves(sj)
    assert len(leaves_j) == len(tree_leaves(st))
    for a, b in zip(leaves_j, tree_leaves(st)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    save_checkpoint(tmp_path / "port", 3, st, extra={"data_step": 3})
    mj = _manifest(tmp_path / "jax" / "step_00000003")
    mt = _manifest(tmp_path / "port" / "step_00000003")
    assert set(mt["leaves"]) == set(mj["leaves"])
    assert mt == mj
    assert {"opt/step", "params/embed", "params/final_norm/scale"} <= \
        set(mt["leaves"])
    assert any(k.startswith("params/stages/0/0/") for k in mt["leaves"])


@pytest.mark.parametrize("arch", CROSS)
def test_port_checkpoint_restores_in_jax(arch, tmp_path):
    cfg = get_config(arch, smoke=True)
    st = steps.init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(tmp_path, 11, st, extra={"data_step": 11})
    cfg_j = j_get_config(arch, smoke=True)
    like = jax.eval_shape(lambda k: j_steps.init_train_state(cfg_j, k),
                          jax.random.PRNGKey(0))
    rj, step, extra = j_checkpoint.restore_checkpoint(tmp_path, like)
    assert step == 11 and extra == {"data_step": 11}
    for a, b in zip(jax.tree.leaves(rj), tree_leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_restore_refuses_what_it_cannot_hold(tmp_path):
    s = _state()
    save_checkpoint(tmp_path, 1, s)
    like = _meta(s)
    like["params"]["w"] = torch.empty((8, 9), device="meta")
    with pytest.raises(ValueError, match="params/w: shape"):
        restore_checkpoint(tmp_path, like, device="cpu")
    like = _meta(s)
    like["params"]["extra"] = torch.empty((1,), device="meta")
    with pytest.raises(KeyError, match="params/extra"):
        restore_checkpoint(tmp_path, like, device="cpu")
    with pytest.raises(ValueError, match="shardings hold 0 leaves"):
        restore_checkpoint(tmp_path, _meta(s), device="cpu", shardings={})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", _meta(s), device="cpu")
    s["opt"]["m"] = s["opt"]["m"].bfloat16()
    with pytest.raises(TypeError, match="opt/m"):
        save_checkpoint(tmp_path, 2, s)
    assert latest_step(tmp_path) == 1


# --- the train loop --------------------------------------------------------

#: the CLI's checkpoints go to --ckpt-dir/<config name>
SMOKE_NAME = get_config("stablelm_1_6b", smoke=True).name


def _cli(tmp_path, *extra, inject_failure_at=None):
    return train.main(["--arch", "stablelm_1_6b", "--smoke", "--steps", "6",
                       "--batch", "4", "--seq", "16", "--microbatches", "2",
                       "--save-every", "2", "--ckpt-dir", str(tmp_path),
                       "--device", "cpu", *extra],
                      inject_failure_at=inject_failure_at)


def test_train_cli_and_resume_restart_exact(tmp_path, capsys):
    """``launch.train --arch stablelm_1_6b --smoke --device cpu``
    uninterrupted; then a run whose worker is lost at step 5 (checkpoint
    at 4) and ``--resume``: the resumed run continues from step 4 with the
    same token batches, and ends on the uninterrupted run's state, bit for
    bit."""
    ref = _cli(tmp_path / "ref")
    out = capsys.readouterr().out
    assert ref.last == 6 and len(ref.metrics) == 6
    assert "step     1  loss" in out and "gnorm" in out
    assert "done: 6 steps" in out
    assert latest_step(tmp_path / "ref" / SMOKE_NAME) == 6
    assert np.isfinite([m["loss"] for m in ref.metrics]).all()

    with pytest.raises(WorkerLost):
        _cli(tmp_path / "run", inject_failure_at=5)
    assert latest_step(tmp_path / "run" / SMOKE_NAME) == 4
    got = _cli(tmp_path / "run", "--resume")
    assert "resumed from step 4" in got.events
    assert got.last == 6 and len(got.metrics) == 2
    assert [m["loss"] for m in got.metrics] == \
        [m["loss"] for m in ref.metrics[4:]]
    _equal(got.state, ref.state)


def test_supervisor_resume_restart_exact_on_a_model(tmp_path):
    """mamba2-130m smoke under the supervisor with async checkpoints: lost
    at step 3, resumed from step 2, its final state equals an
    uninterrupted run's bit for bit."""
    cfg = get_config("mamba2_130m", smoke=True)
    step = steps.make_train_step(cfg, steps.TrainConfig(
        microbatches=2, peak_lr=1e-3, warmup_steps=2, total_steps=4))
    ts = TokenStream(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2)

    def step_fn(state, tokens):
        return step(state, {"tokens": torch.as_tensor(tokens)})

    def sup(name):
        return TrainSupervisor(
            store=CheckpointStore(tmp_path / name, keep=2, async_save=True,
                                  device="cpu"),
            pipeline=ShardedDataPipeline(ts), monitor=HeartbeatMonitor(1),
            save_every=2)

    def fresh():
        return steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                      "cpu")
    a = sup("ref")
    ref, _ = a.run(fresh(), step_fn, steps=4)
    a.store.wait()
    b = sup("run")
    with pytest.raises(WorkerLost):
        b.run(fresh(), step_fn, steps=4, inject_failure_at=3)
    b.store.wait()
    c = sup("run")
    got, last = c.resume(steps.init_train_state(cfg, None, "meta"), step_fn,
                         steps=4)
    c.store.wait()
    assert last == 4 and "resumed from step 2" in c.events
    _equal(got, ref)
