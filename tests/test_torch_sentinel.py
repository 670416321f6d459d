"""The port's divergence guard and Sentinel against the reference's.

Twins of ``tests/test_sentinel.py``'s ``TestGuardedStep`` and
``TestSentinelPolicy``: the same MLP (the reference's initial weights carried
over by ``params_from_jax``), the same ``SyntheticDigits`` batches through
bitwise-equal loaders, the same chaos faults, in both packages on the CPU in
float32. Each twin holds the port to the reference's own assertions, and
its health rows and losses to the reference's: health rows within 1e-6
(absolute and relative; a suppressed step's non-finite entries equal as
non-finite), losses within 1e-5. A suppressed step is checked bit for bit
on the port: the parameters and every Adam slot, the count included.

Left out: ``TestParity`` (cross-replica checksums over a mesh, ROADMAP
queue 1, 9. Multi-GPU parallelism; the port's ``check_parity`` raises) and
``test_debug_nans_env_knob`` (jax's ``JAX_DEBUG_NANS`` knob). The red
reference test ``test_finite_spike_flagged_by_zscore`` (it asserts
``ok == 0``; the reference gives 1) is twinned as "the port's health rows
equal the reference's", not as its claim.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.checkpoint import Checkpointer as JaxCheckpointer
from tpusystem.data import Loader as JaxLoader
from tpusystem.data import SyntheticDigits as JaxDigits
from tpusystem.models import MLP as JaxMLP
from tpusystem.observe import events as jevents
from tpusystem.parallel import chaos as jchaos
from tpusystem.services import prodcon as jprodcon
from tpusystem_torch import train as ttrain
from tpusystem_torch.checkpoint import Checkpointer
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.data import Loader, SyntheticDigits
from tpusystem_torch.models import MLP
from tpusystem_torch.observe import events as tevents
from tpusystem_torch.parallel import chaos as tchaos
from tpusystem_torch.parallel.recovery import (DIVERGED_EXIT, RESTART_EXITS,
                                               DivergenceError,
                                               exit_for_restart)
from tpusystem_torch.services import prodcon as tprodcon
from tpusystem_torch.train.sentinel import HEALTH_GNORM, HEALTH_OK

IDENTITY = 'sentinel-mlp'
ROW_TOL = 1e-6
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def reference_params(dropout: float):
    module = JaxMLP(features=(16,), classes=10, dropout=dropout)
    return jtrain.init_state(module, jtrain.Adam(lr=1e-2),
                             jnp.zeros((1, 28, 28)), rng=7).params


def ref_parts(*, guard=None, fault=None, seed=3, dropout=0.2, jit=True):
    """The reference's training cell (``test_sentinel.py:make_parts``)."""
    loader = JaxLoader(JaxDigits(samples=40, seed=4), batch_size=8,
                       shuffle=True, seed=seed)
    module = JaxMLP(features=(16,), classes=10, dropout=dropout)
    optimizer = jtrain.Adam(lr=1e-2)
    state = jtrain.init_state(module, optimizer, jnp.zeros((1, 28, 28)),
                              rng=7)
    if guard is not None:
        state = guard.arm(state)
    step = jtrain.build_train_step(jtrain.flax_apply(module),
                                   jtrain.CrossEntropyLoss(), optimizer,
                                   guard=guard, fault=fault, jit=jit)
    return loader, state, step


def port_parts(*, guard=None, fault=None, seed=3, dropout=0.2):
    """The port's twin cell: the reference's initial weights, the same
    loader seeds, the same state key."""
    loader = Loader(SyntheticDigits(samples=40, seed=4), batch_size=8,
                    shuffle=True, seed=seed, device='cpu')
    module = MLP(features=(16,), classes=10, dropout=dropout, device='cpu')
    module.load_state_dict(params_from_jax(reference_params(dropout)))
    optimizer = ttrain.Adam(lr=1e-2)
    state = ttrain.init_state(module, optimizer, rng=7)
    if guard is not None:
        state = guard.arm(state)
    step = ttrain.build_train_step(ttrain.module_apply(module),
                                   ttrain.CrossEntropyLoss(), optimizer,
                                   guard=guard, fault=fault)
    return loader, state, step


def snapshot(state) -> list:
    """Clones of the parameters and every optimizer slot (the count too)."""
    opt = state.opt_state
    return ([tensor.detach().clone() for tensor in state.params.values()]
            + [opt['count'].clone()]
            + [tensor.clone() for tensor in opt['mu'].values()]
            + [tensor.clone() for tensor in opt['nu'].values()])


def assert_rows_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=ROW_TOL,
                               atol=ROW_TOL)


def spike_batch():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((8, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, (8,)).astype(np.int32)
    return images, labels


class TestGuardedStep:
    """The on-card rung: detection and suppression inside the step."""

    def test_healthy_run_matches_unguarded_bitwise(self):
        """guard= is a bit-for-bit no-op on a healthy run (the update is
        scaled by 1.0 and the new branch selected), and its health rows are
        the reference's."""
        guard = ttrain.Guard()
        loader, plain_state, plain_step = port_parts()
        loader2, guarded_state, guarded_step = port_parts(guard=guard)
        ref_loader, ref_state, ref_step = ref_parts(guard=jtrain.Guard())
        for (inputs, targets), (inputs2, targets2), (ref_in, ref_t) in zip(
                loader, loader2, ref_loader):
            plain_state, (_, plain_loss) = plain_step(plain_state, inputs,
                                                      targets)
            guarded_state, (_, guarded_loss) = guarded_step(
                guarded_state, inputs2, targets2)
            ref_state, (_, ref_loss) = ref_step(ref_state, ref_in, ref_t)
            assert float(plain_loss) == float(guarded_loss)
            assert abs(float(guarded_loss) - float(ref_loss)) <= LOSS_TOL
            assert_rows_close(guarded_state.health.last,
                              ref_state.health.last)
        for a, b in zip(plain_state.params.values(),
                        guarded_state.params.values()):
            assert torch.equal(a, b)
        assert int(guarded_state.health.bad_steps) == 0
        assert int(guarded_state.health.count) == 5

    def test_nan_grads_suppress_update_bitwise(self):
        """CorruptGrads NaN at step 3: the parameters and every Adam slot
        (the count too) after the bad step are bit for bit the step-2
        values, the step counter advances, the EMA is not folded, and
        training continues finite; every row equals the reference's."""
        guard = ttrain.Guard()
        loader, state, step = port_parts(
            guard=guard, fault=tchaos.CorruptGrads(step=3))
        ref_loader, ref_state, ref_step = ref_parts(
            guard=jtrain.Guard(), fault=jchaos.CorruptGrads(step=3))
        frozen = False
        for (inputs, targets), (ref_in, ref_t) in zip(loader, ref_loader):
            before = snapshot(state)
            before_ema = float(state.health.ema_norm)
            state, (_, loss) = step(state, inputs, targets)
            ref_state, _ = ref_step(ref_state, ref_in, ref_t)
            assert_rows_close(state.health.last, ref_state.health.last)
            if int(state.step) == 3:
                frozen = True
                row = state.health.last.numpy()
                assert row[HEALTH_OK] == 0.0
                assert not np.isfinite(row[HEALTH_GNORM])
                assert int(state.health.bad_steps) == 1
                for old, new in zip(before, snapshot(state)):
                    assert torch.equal(old, new)
                assert float(state.health.ema_norm) == before_ema
            else:
                assert np.isfinite(float(loss))
        assert frozen
        assert int(state.step) == 5 and int(state.health.bad_steps) == 1
        assert int(state.opt_state['count']) == 4     # Adam saw 4 updates

    def test_finite_spike_rows_equal_the_reference(self):
        """Twin of the red ``test_finite_spike_flagged_by_zscore``: eight
        steps of one batch at dropout 0 with a 200x spike at step 8,
        warmup 4. Each step's loss and gradients come from the reference's
        state and go through both packages' ``Guard.judge``: every health
        row (the spike's z-score included) within 1e-6, whatever the
        verdict. (Trained eight steps apart, the two packages' rows drift
        further: Adam turns float32 noise in near-zero gradients into
        lr-sized steps, ROADMAP queue 3's AdamW trap.) Then the port's own
        run: a step it suppresses leaves the parameters bit for bit."""
        reference_guard = jtrain.Guard(warmup=4, zmax=6.0)
        guard = ttrain.Guard(warmup=4, zmax=6.0)
        module = JaxMLP(features=(16,), classes=10, dropout=0.0)
        _, ref_state, ref_step = ref_parts(guard=reference_guard,
                                           dropout=0.0)
        images, labels = spike_batch()
        criterion = jtrain.CrossEntropyLoss()

        def objective(params):
            return criterion(module.apply({'params': params},
                                          jnp.asarray(images)),
                             jnp.asarray(labels))

        ref_health = ref_state.health
        health = ttrain.HealthStats.create('cpu')
        names = list(params_from_jax(ref_state.params))
        for at in range(1, 9):
            loss, grads = jax.value_and_grad(objective)(ref_state.params)
            if at == 8:
                grads = jax.tree.map(lambda leaf: leaf * 200.0, grads)
            ref_health, _ = reference_guard.judge(ref_health, loss, grads)
            port_grads = params_from_jax(grads)
            guard.judge(health, torch.tensor(float(loss)),
                        [port_grads[name] for name in names])
            assert_rows_close(health.last, ref_health.last)
            ref_state, _ = ref_step(ref_state, jnp.asarray(images),
                                    jnp.asarray(labels))
        _, state, step = port_parts(guard=guard, dropout=0.0, fault=
                                    tchaos.CorruptGrads(step=8, mode='spike',
                                                        scale=200.0))
        for _ in range(8):
            before = snapshot(state)
            state, _ = step(state, torch.from_numpy(images),
                            torch.from_numpy(labels))
            if state.health.last[HEALTH_OK] == 0.0:
                for old, new in zip(before, snapshot(state)):
                    assert torch.equal(old, new)
        assert np.isfinite(float(state.health.last[HEALTH_GNORM]))

    def test_spike_detector_respects_warmup(self):
        """Before ``warmup`` healthy steps the same spike passes."""
        guard = ttrain.Guard(warmup=100)
        _, state, step = port_parts(guard=guard, dropout=0.0, fault=
                                    tchaos.CorruptGrads(step=3, mode='spike',
                                                        scale=200.0))
        _, ref_state, ref_step = ref_parts(
            guard=jtrain.Guard(warmup=100), dropout=0.0,
            fault=jchaos.CorruptGrads(step=3, mode='spike', scale=200.0))
        images, labels = spike_batch()
        for _ in range(3):
            state, _ = step(state, torch.from_numpy(images),
                            torch.from_numpy(labels))
            ref_state, _ = ref_step(ref_state, jnp.asarray(images),
                                    jnp.asarray(labels))
            assert_rows_close(state.health.last, ref_state.health.last)
        assert int(state.health.bad_steps) == 0
        assert state.health.last[HEALTH_OK] == 1.0

    def test_lr_scale_scales_the_update_exactly(self):
        """``lr_scale = 0.5`` halves the applied update (compared through a
        params-sized subtraction, hence allclose, as the reference does)."""
        guard = ttrain.Guard()
        _, state_full, step = port_parts(guard=guard, dropout=0.0)
        _, state_half, _ = port_parts(guard=guard, dropout=0.0)
        state_half.health.lr_scale.fill_(0.5)
        rng = np.random.default_rng(1)
        images = torch.from_numpy(
            rng.standard_normal((8, 28, 28)).astype(np.float32))
        labels = torch.from_numpy(rng.integers(0, 10, (8,)))
        initial = [tensor.detach().clone()
                   for tensor in state_full.params.values()]
        state_full, _ = step(state_full, images, labels)
        full = [tensor.detach().clone()
                for tensor in state_full.params.values()]
        state_half, _ = step(state_half, images, labels)
        for start, whole, half in zip(initial, full,
                                      state_half.params.values()):
            np.testing.assert_allclose(((whole - start) * 0.5).numpy(),
                                       (half.detach() - start).numpy(),
                                       rtol=1e-4, atol=1e-7)

    def test_multi_step_stacks_per_step_health(self):
        """build_multi_step(guard=True): ``[N]`` losses and ``[N, 4]``
        health rows, step 2 suppressed; equal bit for bit to five single
        steps, and within tolerance of the reference's scanned dispatch."""
        guard = ttrain.Guard()
        fault = tchaos.CorruptGrads(step=2)
        loader, state, _ = port_parts(guard=guard)
        _, single_state, single = port_parts(guard=guard, fault=fault)
        module = MLP(features=(16,), classes=10, dropout=0.2, device='cpu')
        module.load_state_dict(params_from_jax(reference_params(0.2)))
        state = ttrain.init_state(module, ttrain.Adam(lr=1e-2), rng=7)
        state = guard.arm(state)
        inner = ttrain.build_train_step(
            ttrain.module_apply(module), ttrain.CrossEntropyLoss(),
            ttrain.Adam(lr=1e-2), guard=guard, fault=fault, jit=False)
        multi = ttrain.build_multi_step(inner, guard=True)
        (inputs, targets), = ttrain.grouped_batches(loader, 5)
        state, (losses, health) = multi(state, inputs, targets)
        assert losses.shape == (5,) and health.shape == (5, 4)
        assert health[1, HEALTH_OK] == 0.0
        assert health[[0, 2, 3, 4], HEALTH_OK].tolist() == [1.0] * 4
        assert int(state.health.bad_steps) == 1
        for index in range(5):
            single_state, (_, loss) = single(single_state, inputs[index],
                                             targets[index])
            assert float(loss) == float(losses[index])
            torch.testing.assert_close(single_state.health.last,
                                       health[index], rtol=0, atol=0,
                                       equal_nan=True)
        for a, b in zip(state.params.values(), single_state.params.values()):
            assert torch.equal(a, b)
        ref_loader, ref_state, _ = ref_parts(guard=jtrain.Guard())
        ref_inner = jtrain.build_train_step(
            jtrain.flax_apply(JaxMLP(features=(16,), classes=10,
                                     dropout=0.2)),
            jtrain.CrossEntropyLoss(), jtrain.Adam(lr=1e-2),
            guard=jtrain.Guard(), fault=jchaos.CorruptGrads(step=2),
            jit=False)
        (ref_inputs, ref_targets), = jtrain.grouped_batches(ref_loader, 5)
        _, (ref_losses, ref_health) = jtrain.build_multi_step(
            ref_inner, guard=True)(ref_state, ref_inputs, ref_targets)
        np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert_rows_close(health, ref_health)

    def test_guard_requires_armed_state(self):
        guard = ttrain.Guard()
        module = MLP(features=(16,), classes=10, device='cpu')
        optimizer = ttrain.Adam(lr=1e-2)
        step = ttrain.build_train_step(ttrain.module_apply(module),
                                       ttrain.CrossEntropyLoss(), optimizer,
                                       guard=guard)
        state = ttrain.init_state(module, optimizer)        # unarmed
        with pytest.raises(AssertionError, match='arm'):
            step(state, torch.zeros((8, 28, 28)),
                 torch.zeros((8,), dtype=torch.int64))

    def test_guard_identity_equals_the_references(self):
        from tpusystem.registry import gethash as jax_gethash
        from tpusystem_torch.registry import gethash
        for kwargs in ({}, {'zmax': 4.0, 'warmup': 8}):
            assert gethash(ttrain.Guard(**kwargs)) == jax_gethash(
                jtrain.Guard(**kwargs))

    def test_check_parity_waits_for_multi_gpu(self):
        """On a one-device mesh there is one replica, so parity holds even
        after a flip; the replicas of a mesh of ranks are
        ``tests/test_torch_parallel.py``'s (gloo processes)."""
        from tpusystem_torch.parallel import FlipParamBit, single_device_mesh
        mesh = single_device_mesh('cpu')
        params = {'w': torch.arange(6, dtype=torch.float32),
                  'b': torch.ones(2)}
        assert ttrain.Sentinel().check_parity(params, mesh) is None
        FlipParamBit(leaf=1, index=1, bit=3)(params, mesh)
        assert ttrain.Sentinel().check_parity(params, mesh) is None
        assert params['b'][1] != 1.0


def capture(producer_module, consumer_module, *event_types):
    producer = producer_module.Producer()
    consumer = consumer_module.Consumer()
    seen = []
    for event_type in event_types:
        consumer.register(event_type, seen.append)
    producer.register(consumer)
    return producer, seen


def drive(loader, state, step, sentinel, *, until, corrupt=None,
          checkpointer=None, healthy=None):
    """``test_sentinel.py``'s epoch loop (step, checkpoint, review) for
    either package; ``healthy(state)`` reads the last row's verdict."""
    losses = []
    while True:
        for inputs, targets in loader:
            if corrupt is not None:
                inputs = corrupt(inputs)
            state, (_, loss) = step(state, inputs, targets)
            losses.append((int(state.step), float(loss)))
            if checkpointer is not None:
                extras = (ttrain if isinstance(checkpointer, Checkpointer)
                          else jtrain).resume_extras(state, loader)
                checkpointer.save(IDENTITY, int(state.step), state,
                                  extras=extras)
            state = sentinel.review(state)
            if int(state.step) >= until and healthy(state):
                return state, losses


def port_healthy(state) -> bool:
    return bool(state.health.last[HEALTH_OK] >= 0.5)


def ref_healthy(state) -> bool:
    return bool(np.asarray(state.health.last)[HEALTH_OK] >= 0.5)


def assert_losses_close(got, want):
    assert [at for at, _ in got] == [at for at, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= LOSS_TOL


class TestSentinelPolicy:
    """The host-side ladder over the health rows, at review cadence."""

    def test_anomaly_events_emitted_at_review(self):
        producer, seen = capture(tprodcon, tprodcon, tevents.AnomalyDetected)
        loader, state, step = port_parts(guard=ttrain.Guard(),
                                         fault=tchaos.CorruptGrads(step=2))
        sentinel = ttrain.Sentinel(producer=producer, model='drill')
        state, losses = drive(loader, state, step, sentinel, until=4,
                              healthy=port_healthy)
        assert [event.step for event in seen] == [2]
        assert seen[0].kind == 'nonfinite' and seen[0].model == 'drill'
        assert not np.isfinite(seen[0].gnorm)
        ref_producer, ref_seen = capture(jprodcon, jprodcon,
                                         jevents.AnomalyDetected)
        ref = ref_parts(guard=jtrain.Guard(),
                        fault=jchaos.CorruptGrads(step=2))
        _, ref_losses = drive(*ref, jtrain.Sentinel(producer=ref_producer,
                                                    model='drill'),
                              until=4, healthy=ref_healthy)
        assert [(e.step, e.kind, e.model) for e in seen] == [
            (e.step, e.kind, e.model) for e in ref_seen]
        assert_losses_close(losses, ref_losses)

    def test_backoff_then_recovery(self):
        """One bad step at backoff_after=1 halves lr_scale (event and hook);
        a healthy streak of recover_after restores full rate."""
        def run(P, train, prodcon, events, chaos, parts, healthy):
            producer, seen = capture(prodcon, prodcon, events.BackoffApplied)
            hook_calls = []
            loader, state, step = parts(guard=train.Guard(),
                                        fault=chaos.CorruptGrads(step=2))
            sentinel = train.Sentinel(producer=producer, backoff_after=1,
                                      recover_after=2, window=8,
                                      on_backoff=lambda level, scale:
                                      hook_calls.append((level, scale)))
            state, losses = drive(loader, state, step, sentinel, until=5,
                                  healthy=healthy)
            return ([(event.level, event.scale) for event in seen],
                    hook_calls, float(np.asarray(state.health.lr_scale)),
                    losses)

        port = run('port', ttrain, tprodcon, tevents, tchaos, port_parts,
                   port_healthy)
        assert port[0] == [(1, 0.5), (0, 1.0)]
        assert port[1] == [(1, 0.5)]
        assert port[2] == 1.0
        ref = run('ref', jtrain, jprodcon, jevents, jchaos, ref_parts,
                  ref_healthy)
        assert port[:3] == ref[:3]
        assert_losses_close(port[3], ref[3])

    def test_rollback_skip_window_matches_fault_free_reference(self, tmp_path):
        """Batches feeding steps 6-9 are poisoned (CorruptBatch); the guard
        suppresses the four updates, the Sentinel rolls back to step 5 in
        place and keeps the loader's cursor. From there the port's
        trajectory equals a fault-free port run that skipped the same
        batches, bit for bit, and the reference's drill within 1e-5."""
        guard = ttrain.Guard()
        producer, seen = capture(tprodcon, tprodcon, tevents.RolledBack)
        loader, state, step = port_parts(guard=guard)
        reference = {}
        iterator = iter(loader)
        while int(state.step) < 5:
            inputs, targets = next(iterator)
            state, _ = step(state, inputs, targets)
        iterator.close()
        loader.seek({'epoch': 1, 'batch': 4})
        while int(state.step) < 8:
            for inputs, targets in loader:
                state, (_, loss) = step(state, inputs, targets)
                reference[int(state.step)] = float(loss)
                if int(state.step) >= 8:
                    break

        loader, state, step = port_parts(guard=guard)
        with Checkpointer(tmp_path / 'port', async_save=False,
                          max_to_keep=None) as checkpointer:
            sentinel = ttrain.Sentinel(
                checkpointer=checkpointer, identity=IDENTITY, loader=loader,
                producer=producer, rollback_after=4, window=8)
            state, losses = drive(
                loader, state, step, sentinel, until=8,
                corrupt=tchaos.CorruptBatch(batch=6, steps=4),
                checkpointer=checkpointer, healthy=port_healthy)
            assert [event.to_step for event in seen] == [5]
            assert seen[0].step == 9
            assert seen[0].window['to'] == {'epoch': 1, 'batch': 4}
            assert checkpointer.latest(IDENTITY) == 8
            assert sentinel.level == 0
            assert float(state.health.lr_scale) == 1.0
        resumed = dict(losses[-3:])
        assert sorted(resumed) == [6, 7, 8]
        for at in (6, 7, 8):
            assert resumed[at] == reference[at], (at, resumed, reference)

        ref_loader, ref_state, ref_step = ref_parts(guard=jtrain.Guard())
        with JaxCheckpointer(tmp_path / 'ref', async_save=False,
                             max_to_keep=None) as ref_checkpointer:
            ref_sentinel = jtrain.Sentinel(
                checkpointer=ref_checkpointer, identity=IDENTITY,
                loader=ref_loader, rollback_after=4, window=8)
            _, ref_losses = drive(
                ref_loader, ref_state, ref_step, ref_sentinel, until=8,
                corrupt=jchaos.CorruptBatch(batch=6, steps=4),
                checkpointer=ref_checkpointer, healthy=ref_healthy)
        assert_losses_close(losses, ref_losses)

    def test_persistent_divergence_bounded_giveup(self, tmp_path):
        """CorruptGrads is keyed on the step counter, so the rollback
        rewinds into the fault window: the second attempt gives up with
        DivergenceError -> exit code 44 (not a restart code)."""
        loader, state, step = port_parts(
            guard=ttrain.Guard(), fault=tchaos.CorruptGrads(step=6, steps=4))
        with Checkpointer(tmp_path, async_save=False,
                          max_to_keep=None) as checkpointer:
            sentinel = ttrain.Sentinel(
                checkpointer=checkpointer, identity=IDENTITY, loader=loader,
                rollback_after=4, window=8, max_rollbacks=1)
            with pytest.raises(DivergenceError) as excinfo:
                drive(loader, state, step, sentinel, until=20,
                      checkpointer=checkpointer, healthy=port_healthy)
        assert sentinel.rollbacks == 1
        assert exit_for_restart(excinfo.value).code == DIVERGED_EXIT
        assert DIVERGED_EXIT not in RESTART_EXITS

    def test_rollback_without_predating_checkpoint_gives_up(self, tmp_path):
        loader, state, step = port_parts(
            guard=ttrain.Guard(), fault=tchaos.CorruptGrads(step=1))
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            sentinel = ttrain.Sentinel(checkpointer=checkpointer,
                                       identity=IDENTITY, loader=loader,
                                       rollback_after=1)
            with pytest.raises(DivergenceError, match='predates'):
                drive(loader, state, step, sentinel, until=3,
                      checkpointer=checkpointer, healthy=port_healthy)

    def test_sentinel_checkpointer_requires_identity(self, tmp_path):
        with Checkpointer(tmp_path) as checkpointer:
            with pytest.raises(ValueError, match='identity'):
                ttrain.Sentinel(checkpointer=checkpointer)


@pytest.mark.parametrize('name, kwargs', [
    ('SGD', dict(lr=0.1)), ('SGD', dict(lr=0.1, momentum=0.9)),
    ('SGD', dict(lr=0.1, momentum=0.9, nesterov=True)),
    ('Adam', dict(lr=1e-2)),
    ('AdamW', dict(lr=1e-2, grad_clip=0.5, warmup_steps=2, decay_steps=6)),
])
def test_masked_update_is_the_plain_update_or_nothing(name, kwargs):
    """``masked_update`` with ``ok`` True and ``scale`` 1 is the plain
    step bit for bit; a step with ``ok`` False (NaN gradients) moves
    nothing, the count and every slot included, so the run equals one that
    never took it; ``scale`` 0.5 halves the applied update."""
    generator = torch.Generator().manual_seed(0)
    params = {'w': torch.randn(5, 3, generator=generator),
              'b': torch.randn(3, generator=generator)}
    grads = [{key: torch.randn(value.shape, generator=generator)
              for key, value in params.items()} for _ in range(3)]

    def run(steps, bad=(), scale=None):
        """``(params, slots)`` flattened after ``steps``; masked updates
        unless ``scale`` is None and nothing is ``bad``."""
        optimizer = getattr(ttrain, name)(**kwargs)
        state = {key: value.clone() for key, value in params.items()}
        slots = optimizer.init(state)
        for index, grad in enumerate(steps):
            if scale is None and not bad:
                optimizer.step(state, grad, slots)
                continue
            if index in bad:
                grad = {key: torch.full_like(value, float('nan'))
                        for key, value in grad.items()}
            ttrain.masked_update(optimizer, grad, slots, state,
                                 torch.tensor(index not in bad),
                                 scale=torch.tensor(scale or 1.0))
        return (list(state.values()) + [slots['count']]
                + [tensor for key in ('mu', 'nu', 'trace')
                   for tensor in slots.get(key, {}).values()])

    for got, want in zip(run(grads, scale=1.0), run(grads)):
        assert torch.equal(got, want)
    for got, want in zip(run(grads, bad=(1,)), run([grads[0], grads[2]])):
        assert torch.equal(got, want)
    half, full = run(grads[:1], scale=0.5), run(grads[:1])
    for index, key in enumerate(params):
        np.testing.assert_allclose(
            (half[index] - params[key]).numpy(),
            ((full[index] - params[key]) * 0.5).numpy(), rtol=1e-5,
            atol=1e-7)


def test_corrupt_batch_and_flip_param_bit():
    """``CorruptBatch`` poisons the floating leaves of its window of fed
    batches only; ``FlipParamBit`` flips one bit of one element in place."""
    corrupt = tchaos.CorruptBatch(batch=2, steps=2)
    images, labels = torch.ones(2, 3), torch.arange(2)
    fed = [corrupt((images, labels)) for _ in range(4)]
    assert [bool(torch.isnan(batch[0]).all()) for batch in fed] == [
        False, True, True, False]
    assert all(torch.equal(batch[1], labels) for batch in fed)
    params = {'a': torch.zeros(4), 'b': torch.ones(3, dtype=torch.float32)}
    before = params['b'].clone()
    tchaos.FlipParamBit(leaf=1, index=2, bit=31)(params)
    assert params['b'][2].item() == -1.0       # the sign bit
    assert torch.equal(params['b'][:2], before[:2])
    assert torch.equal(params['a'], torch.zeros(4))
