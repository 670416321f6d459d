"""The port's Checkpointer and Repository, held to the reference's tests.

Twins of ``tests/test_checkpoint.py`` and of ``tests/test_chaos.py``'s
checkpoint drills (``TestStepGranularResume::
test_kill_at_step_restart_resumes_bitwise``, ``TestCorruptCheckpoints``,
``TestFlakySaves``, ``TestPreemption::
test_preemption_mid_training_fences_and_resumes``, ``TestRecoveryPaths::
test_worker_lost_unwinds_with_pending_async_save``) on the port's MLP cell
(the reference's initial weights, bitwise-equal loaders). The port writes
its own store (``torch.save`` payload and a digest marker), so each twin
holds the port to the reference's assertions on its own; the trajectories
are also held to the reference's uninterrupted losses within 1e-5.

The two red reference tests are held to their docstrings on the port:
a payload torn where the integrity probe cannot see it still falls back,
and a checkpoint written before ``health`` existed restores into an
unarmed state while an armed target is refused. Left out:
``test_restore_onto_sharded_target`` (a mesh, ROADMAP queue 1, 9.
Multi-GPU parallelism). Added: a state changed in place right after an
async ``save`` restores as it was at the save.
"""

from __future__ import annotations

import functools
import json
import logging
import os
import shutil
import signal as signal_module
import time

import jax.numpy as jnp
import pytest
import torch

from tpusystem import train as jtrain
from tpusystem.data import Loader as JaxLoader
from tpusystem.data import SyntheticDigits as JaxDigits
from tpusystem.models import MLP as JaxMLP
from tpusystem_torch import train as ttrain
from tpusystem_torch.checkpoint import Checkpointer, Repository
from tpusystem_torch.convert import params_from_jax
from tpusystem_torch.data import Loader, SyntheticDigits
from tpusystem_torch.models import MLP
from tpusystem_torch.parallel.chaos import DieAtStep, WorkerKilled
from tpusystem_torch.parallel.multihost import WorkerLost
from tpusystem_torch.parallel.recovery import (PREEMPTED_EXIT, RESTART_EXITS,
                                               Preempted, WorkerLostError,
                                               exit_for_restart,
                                               recovery_consumer)
from tpusystem_torch.registry import gethash
from tpusystem_torch.runtime import Runtime

IDENTITY = 'chaos-mlp'
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def reference_params():
    module = JaxMLP(features=(16,), classes=10, dropout=0.2)
    return jtrain.init_state(module, jtrain.Adam(lr=1e-2),
                             jnp.zeros((1, 28, 28)), rng=7).params


def make_parts():
    """``test_chaos.py:make_parts`` on the port: loader, state, step."""
    loader = Loader(SyntheticDigits(samples=40, seed=4), batch_size=8,
                    shuffle=True, seed=3, device='cpu')
    module = MLP(features=(16,), classes=10, dropout=0.2, device='cpu')
    module.load_state_dict(params_from_jax(reference_params()))
    optimizer = ttrain.Adam(lr=1e-2)
    state = ttrain.init_state(module, optimizer, rng=7)
    step = ttrain.build_train_step(ttrain.module_apply(module),
                                   ttrain.CrossEntropyLoss(), optimizer)
    return loader, state, step


def blank_parts():
    """A fresh cell whose state is zeroed: a restore must fill it all."""
    loader, state, step = make_parts()
    with torch.no_grad():
        for tensor in state.params.values():
            tensor.zero_()
    return loader, state, step


def leaves(state) -> list:
    opt = state.opt_state
    return ([t.detach().clone() for t in state.params.values()]
            + [opt['count'].clone(), state.step.clone()]
            + [t.clone() for t in opt['mu'].values()]
            + [t.clone() for t in opt['nu'].values()])


def assert_same(left, right):
    for a, b in zip(leaves(left) if not isinstance(left, list) else left,
                    leaves(right) if not isinstance(right, list) else right):
        assert torch.equal(a, b)


def drive(loader, state, step, checkpointer, *, until, die=None):
    """``test_chaos.py:drive``: steps to ``until``, checkpointing each step
    with the loader's cursor; returns ``(state, {step: loss})``."""
    losses = {}
    while int(state.step) < until:
        for inputs, targets in loader:
            state, (_, loss) = step(state, inputs, targets)
            at = int(state.step)
            losses[at] = float(loss)
            if checkpointer is not None:
                checkpointer.save(IDENTITY, at, state,
                                  extras=ttrain.resume_extras(state, loader))
            if die is not None:
                die(at)
            if at == until:
                return state, losses
    return state, losses


@functools.lru_cache(maxsize=None)
def reference_losses(until: int) -> dict:
    """The reference's uninterrupted trajectory of the same cell."""
    loader = JaxLoader(JaxDigits(samples=40, seed=4), batch_size=8,
                       shuffle=True, seed=3)
    module = JaxMLP(features=(16,), classes=10, dropout=0.2)
    optimizer = jtrain.Adam(lr=1e-2)
    state = jtrain.init_state(module, optimizer, jnp.zeros((1, 28, 28)),
                              rng=7)
    step = jtrain.build_train_step(jtrain.flax_apply(module),
                                   jtrain.CrossEntropyLoss(), optimizer)
    _, losses = drive(loader, state, step, None, until=until)
    return losses


def wait_until(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# ---------------------------------------------------------------------------
# twins of tests/test_checkpoint.py


def test_save_restore_roundtrip(tmp_path):
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save('model-a', 0, state)
        _, blank, _ = blank_parts()
        restored = ckpt.restore('model-a', blank)
    assert restored is blank                    # restored in place
    assert_same(state, restored)
    assert restored.rng == state.rng


def test_latest_and_epochs_track_versions(tmp_path):
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=False, max_to_keep=None) as ckpt:
        assert ckpt.latest('m') is None
        for epoch in (0, 1, 2):
            ckpt.save('m', epoch, state)
        assert ckpt.latest('m') == 2
        assert ckpt.epochs('m') == [0, 1, 2]
        assert ckpt.latest('other') is None


def test_restore_missing_identity_raises(tmp_path):
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        with pytest.raises(FileNotFoundError):
            ckpt.restore('nope', state)


def test_async_save_commits_after_wait(tmp_path):
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=True) as ckpt:
        ckpt.save('m', 0, state)
        ckpt.wait()
        assert ckpt.latest('m') == 0


def test_restore_refuses_a_target_that_does_not_match(tmp_path):
    """The port restores into the target's tensors: a leaf of another
    dtype or shape, or a missing one, is refused before anything is
    written."""
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save('m', 0, state)
        _, blank, _ = blank_parts()
        before = leaves(blank)
        name = next(iter(blank.params))
        blank.params[name] = blank.params[name].double()
        with pytest.raises(ValueError, match=name.replace('.', r'\.')):
            ckpt.restore('m', blank, epoch=0)
        _, other, _ = blank_parts()
        other.params.pop(name)
        with pytest.raises(ValueError, match='unexpected'):
            ckpt.restore('m', other, epoch=0)
        for old, new in zip(before[1:], leaves(blank)[1:]):
            assert torch.equal(old, new)        # nothing was written


class FakeAggregate:
    def __init__(self, state, identity='agg'):
        self.state = state
        self._id = identity

    @property
    def id(self):
        return self._id


def test_repository_store_restore_by_identity(tmp_path):
    _, state, _ = make_parts()
    identity = gethash(MLP(features=(16,), classes=10, device='cpu'))
    aggregate = FakeAggregate(state, identity=identity)
    repository = Repository(tmp_path, async_save=False)
    try:
        repository.store(aggregate, epoch=0)
        first = leaves(state)
        with torch.no_grad():
            for tensor in state.params.values():
                tensor.add_(1)
        repository.store(aggregate, epoch=1)
        assert repository.latest(aggregate) == 1
        _, blank, _ = blank_parts()
        clone = FakeAggregate(blank, identity=gethash(
            MLP(features=(16,), classes=10, device='cpu')))
        repository.restore(clone)
        assert_same(state, clone.state)
        repository.restore(clone, epoch=0)
        assert_same(first, leaves(clone.state))
    finally:
        repository.close()


def test_repository_auto_epoch_increments(tmp_path):
    _, state, _ = make_parts()
    aggregate = FakeAggregate(state)
    repository = Repository(tmp_path, async_save=False)
    try:
        repository.store(aggregate)
        repository.store(aggregate)
        assert repository.latest(aggregate) == 1
        aggregate.epoch = 7
        repository.store(aggregate)
        assert repository.latest(aggregate) == 7
    finally:
        repository.close()


def test_gc_keeps_window_plus_periodic(tmp_path):
    _, state, _ = make_parts()
    with Checkpointer(tmp_path, async_save=False, max_to_keep=2,
                      keep_every=4) as ckpt:
        for epoch in range(10):
            ckpt.save('m', epoch, state)
        kept = ckpt.epochs('m')
    assert set(kept) >= {0, 4, 8}
    assert set(kept) >= {8, 9}
    assert 5 not in kept and 6 not in kept


def test_repository_stores_a_module_state_dict(tmp_path):
    """An aggregate's ``state_dict()`` round-trips by registry identity."""
    module = MLP(features=(16,), classes=10, device='cpu')
    aggregate = FakeAggregate(dict(module.state_dict()),
                              identity=gethash(module))
    repository = Repository(tmp_path, async_save=True)
    try:
        repository.store(aggregate, epoch=0)
        repository.wait()
        fresh = MLP(features=(16,), classes=10, device='cpu')
        with torch.no_grad():
            for tensor in fresh.parameters():
                tensor.zero_()
        clone = FakeAggregate(dict(fresh.state_dict()),
                              identity=gethash(fresh))
        repository.restore(clone)
        for name, tensor in module.state_dict().items():
            assert torch.equal(fresh.state_dict()[name], tensor)
    finally:
        repository.close()


# ---------------------------------------------------------------------------
# the in-place snapshot


def test_state_changed_after_an_async_save_restores_as_saved(tmp_path):
    """``save`` snapshots before it returns: the next steps change every
    tensor in place while the commit is in flight, and the restore gives
    the state of the save, not the live one."""
    loader, state, step = make_parts()
    batches = list(loader)
    state, _ = step(state, *batches[0])
    saved = leaves(state)
    with Checkpointer(tmp_path, async_save=True) as ckpt:
        ckpt.save(IDENTITY, 1, state)
        for inputs, targets in batches[1:4]:
            state, _ = step(state, inputs, targets)
        ckpt.wait()
        _, blank, _ = blank_parts()
        restored = ckpt.restore(IDENTITY, blank, epoch=1)
    assert_same(saved, leaves(restored))
    assert not torch.equal(saved[0], next(iter(state.params.values())))


# ---------------------------------------------------------------------------
# twins of tests/test_chaos.py's checkpoint drills


def test_kill_at_step_restart_resumes_bitwise(tmp_path):
    loader, state, step = make_parts()
    _, reference = drive(loader, state, step, None, until=10)
    assert sorted(reference) == list(range(1, 11))
    for at, loss in reference_losses(10).items():
        assert abs(reference[at] - loss) <= LOSS_TOL, at

    loader, state, step = make_parts()
    with Checkpointer(tmp_path, async_save=False) as checkpointer:
        with pytest.raises(WorkerKilled):
            drive(loader, state, step, checkpointer, until=10,
                  die=DieAtStep(step=6))
        checkpointer.fence(IDENTITY)
        loader, blank, step = blank_parts()
        state, resumed_step, extras = checkpointer.resume(IDENTITY, blank)
        assert resumed_step == 6
        assert int(state.step) == 6
        assert extras['step'] == 6
        assert extras['cursor'] == {'epoch': 1, 'batch': 1}
        loader.seek(extras['cursor'])
        _, resumed = drive(loader, state, step, checkpointer, until=10)
    assert sorted(resumed) == list(range(7, 11))
    for at in range(7, 11):
        assert resumed[at] == reference[at], (at, resumed[at], reference[at])


class TestCorruptCheckpoints:

    def plant_truncated(self, root, step):
        """A save torn by a kill: the payload half written, no marker."""
        torn = root / IDENTITY / str(step)
        torn.mkdir(parents=True)
        (torn / 'state.pt').write_bytes(b'torn mid-write')

    def test_truncated_step_dir_skipped_with_logged_fallback(
            self, tmp_path, caplog):
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            state, _ = drive(loader, state, step, checkpointer, until=3)
        self.plant_truncated(tmp_path, 7)
        with Checkpointer(tmp_path, async_save=False) as fresh:
            with caplog.at_level(logging.WARNING,
                                 'tpusystem_torch.checkpoint'):
                assert fresh.latest(IDENTITY) == 3
                assert fresh.epochs(IDENTITY) == [1, 2, 3]
                assert not fresh.verify(IDENTITY, 7)
                assert fresh.verify(IDENTITY, 3)
                _, blank, _ = blank_parts()
                restored, resumed_step, _ = fresh.resume(IDENTITY, blank)
            assert resumed_step == 3
            assert_same(state, restored)
        assert 'incomplete or corrupt' in caplog.text
        assert '7' in caplog.text

    def test_explicit_missing_epoch_lists_available(self, tmp_path):
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            drive(loader, state, step, checkpointer, until=2)
            _, blank, _ = blank_parts()
            with pytest.raises(FileNotFoundError, match=r'epoch 9.*\[1, 2\]'):
                checkpointer.restore(IDENTITY, blank, epoch=9)
            self.plant_truncated(tmp_path, 5)
            with pytest.raises(FileNotFoundError, match=r'epoch 5.*\[1, 2\]'):
                checkpointer.restore(IDENTITY, blank, epoch=5)
            restored = checkpointer.restore(IDENTITY, blank, epoch=1)
            assert int(restored.step) == 1

    def test_flipped_payload_bytes_fail_the_digest(self, tmp_path, caplog):
        """The port's probe hashes the payload: one flipped byte in the
        newest step is caught by ``verify`` and the resume falls back."""
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            drive(loader, state, step, checkpointer, until=3)
        payload = tmp_path / IDENTITY / '3' / 'state.pt'
        data = bytearray(payload.read_bytes())
        data[len(data) // 2] ^= 1
        payload.write_bytes(bytes(data))
        with Checkpointer(tmp_path, async_save=False) as fresh:
            assert not fresh.verify(IDENTITY, 3)
            _, blank, _ = blank_parts()
            with caplog.at_level(logging.WARNING,
                                 'tpusystem_torch.checkpoint'):
                _, resumed_step, _ = fresh.resume(IDENTITY, blank)
            assert resumed_step == 2
        assert 'incomplete or corrupt' in caplog.text

    def test_resume_falls_back_when_probe_passing_payload_is_torn(
            self, tmp_path, caplog):
        """The red reference test's docstring, on the port: a payload torn
        where the probe cannot see it (here: garbage bytes under a marker
        that records their digest, as a writer bug would leave) must still
        fall back, not crash the one-call resume."""
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            state_two = None
            while int(state.step) < 3:
                for inputs, targets in loader:
                    state, _ = step(state, inputs, targets)
                    checkpointer.save(IDENTITY, int(state.step), state)
                    if int(state.step) == 2:
                        state_two = leaves(state)
                    if int(state.step) == 3:
                        break
        step_dir = tmp_path / IDENTITY / '3'
        garbage = b'probe-passing garbage'
        (step_dir / 'state.pt').write_bytes(garbage)
        marker = json.loads((step_dir / '_CHECKPOINT_METADATA').read_text())
        import hashlib
        marker.update(bytes=len(garbage), digest=hashlib.blake2b(
            garbage, digest_size=16).hexdigest())
        (step_dir / '_CHECKPOINT_METADATA').write_text(json.dumps(marker))
        with Checkpointer(tmp_path, async_save=False) as fresh:
            assert fresh.verify(IDENTITY, 3)     # the probe cannot tell
            _, blank, _ = blank_parts()
            with caplog.at_level(logging.WARNING,
                                 'tpusystem_torch.checkpoint'):
                restored, resumed_step, _ = fresh.resume(IDENTITY, blank)
            assert resumed_step == 2
            assert_same(state_two, leaves(restored))
        assert 'falling back' in caplog.text

    def test_repository_auto_version_respects_in_flight_async_save(
            self, tmp_path):
        _, state, _ = make_parts()

        class Model:
            id = IDENTITY
        model = Model()
        model.state = state
        repository = Repository(tmp_path, async_save=True)
        try:
            repository.store(model)
            repository.store(model)
            repository.wait()
            assert repository.latest(model) == 1
        finally:
            repository.close()

    def test_fence_is_monotonic(self, tmp_path):
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            drive(loader, state, step, checkpointer, until=3)
            assert checkpointer.fenced(IDENTITY) is None
            assert checkpointer.fence(IDENTITY) == 3
            assert checkpointer.fenced(IDENTITY) == 3
            shutil.rmtree(tmp_path / IDENTITY / '3')
            assert checkpointer.fence(IDENTITY) == 3
            assert checkpointer.latest(IDENTITY) == 2

    def test_extras_sidecar_pruned_with_gc(self, tmp_path):
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False,
                          max_to_keep=2) as checkpointer:
            drive(loader, state, step, checkpointer, until=6)
            assert checkpointer.epochs(IDENTITY) == [5, 6]
            sidecars = sorted(int(p.stem) for p in
                              (tmp_path / IDENTITY / '.extras').glob('*.json'))
            assert set(sidecars) <= {4, 5, 6}
            assert checkpointer.extras(IDENTITY, 6)['step'] == 6


def test_preemption_mid_training_fences_and_resumes(tmp_path):
    """SIGTERM mid-epoch, Preempted at the next drain, the in-flight async
    save fenced, and the restarted run resumes at the fenced step with a
    bit-for-bit continuation."""
    loader, state, step = make_parts()
    _, reference = drive(loader, state, step, None, until=8)

    loader, state, step = make_parts()
    checkpointer = Checkpointer(tmp_path, async_save=True)
    with Runtime(preemption=True) as runtime:
        with pytest.raises(Preempted) as excinfo:
            while int(state.step) < 8:
                for inputs, targets in loader:
                    state, _ = step(state, inputs, targets)
                    checkpointer.save(
                        IDENTITY, int(state.step), state,
                        extras=ttrain.resume_extras(state, loader))
                    if int(state.step) == 5:
                        os.kill(os.getpid(), signal_module.SIGTERM)
                        assert wait_until(lambda: runtime.preempted)
                    runtime.sync()
        assert checkpointer.fence(IDENTITY) == 5
        assert exit_for_restart(excinfo.value).code == PREEMPTED_EXIT
        assert PREEMPTED_EXIT in RESTART_EXITS
    checkpointer.close()

    with Checkpointer(tmp_path, async_save=False) as fresh:
        loader, blank, step = blank_parts()
        state, resumed_step, extras = fresh.resume(IDENTITY, blank)
        assert resumed_step == 5
        loader.seek(extras['cursor'])
        _, resumed = drive(loader, state, step, fresh, until=8)
    for at in range(6, 9):
        assert resumed[at] == reference[at]


def test_worker_lost_unwinds_with_pending_async_save(tmp_path):
    loader, state, step = make_parts()

    class Model:
        id = IDENTITY

    model = Model()
    model.state = state
    repository = Repository(tmp_path, async_save=True)
    with Runtime() as runtime:
        runtime.producer.register(recovery_consumer())
        for inputs, targets in loader:
            model.state, _ = step(model.state, inputs, targets)
            repository.store(model, int(model.state.step),
                             extras=ttrain.resume_extras(model.state, loader))
            break
        runtime.producer._inbox.put(WorkerLost(rank=1, last_seen=2.0))
        with pytest.raises(WorkerLostError) as excinfo:
            runtime.sync()
        assert excinfo.value.rank == 1
        repository.wait()
        assert repository.fence(model) == 1
    fresh = Repository(tmp_path, async_save=False)
    try:
        _, blank, _ = blank_parts()
        clone = Model()
        clone.state = blank
        resumed_step, extras = fresh.resume(clone)
        assert resumed_step == 1 and int(clone.state.step) == 1
        assert extras['cursor'] == {'epoch': 0, 'batch': 1}
    finally:
        fresh.close()
        repository.close()


class TestFlakySaves:

    def test_save_retries_transient_fs_errors(self, tmp_path, monkeypatch,
                                              caplog):
        _, state, _ = make_parts()
        with Checkpointer(tmp_path, async_save=False,
                          retry_backoff=0.01) as checkpointer:
            manager = checkpointer._manager(IDENTITY)
            real_save, calls = manager.save, []

            def flaky(*args, **kwargs):
                calls.append(1)
                if len(calls) <= 2:
                    raise OSError('EIO: flaky mount')
                return real_save(*args, **kwargs)

            monkeypatch.setattr(manager, 'save', flaky)
            with caplog.at_level(logging.WARNING,
                                 'tpusystem_torch.checkpoint'):
                checkpointer.save(IDENTITY, 1, state)
            assert len(calls) == 3
            assert checkpointer.verify(IDENTITY, 1)
        assert 'retry 1/2' in caplog.text and 'retry 2/2' in caplog.text

    def test_save_gives_up_after_bounded_retries(self, tmp_path, monkeypatch):
        _, state, _ = make_parts()
        with Checkpointer(tmp_path, async_save=False, save_retries=2,
                          retry_backoff=0.01) as checkpointer:
            manager = checkpointer._manager(IDENTITY)
            calls = []

            def dead(*args, **kwargs):
                calls.append(1)
                raise OSError('ENOSPC: disk full')

            monkeypatch.setattr(manager, 'save', dead)
            with pytest.raises(OSError, match='ENOSPC'):
                checkpointer.save(IDENTITY, 1, state)
            assert len(calls) == 3

    def test_async_failure_surfaces_at_next_save_and_newest(
            self, tmp_path, monkeypatch):
        """A background commit that fails raises at the very next save()
        and newest() — here a real one: the writer's torch.save fails."""
        _, state, _ = make_parts()
        checkpointer = Checkpointer(tmp_path, async_save=True)
        try:
            checkpointer.save(IDENTITY, 1, state)
            checkpointer.wait()

            def boom(*args, **kwargs):
                raise OSError('async commit failed: disk full')

            monkeypatch.setattr(torch, 'save', boom)
            checkpointer.save(IDENTITY, 2, state)
            checkpointer._managers[IDENTITY]._queue.join()
            monkeypatch.undo()
            with pytest.raises(OSError, match='async commit failed'):
                checkpointer.save(IDENTITY, 3, state)
            monkeypatch.setattr(torch, 'save', boom)
            checkpointer.save(IDENTITY, 4, state)
            checkpointer._managers[IDENTITY]._queue.join()
            monkeypatch.undo()
            with pytest.raises(OSError, match='async commit failed'):
                checkpointer.newest(IDENTITY)
        finally:
            monkeypatch.undo()
            checkpointer.close()

    def test_legacy_checkpoint_restores_into_grown_train_state(self,
                                                               tmp_path):
        """The red reference test's docstring, on the port: a checkpoint
        written before ``health`` existed restores into an unarmed state
        (health stays None), training continues and arming works; an
        ARMED target is refused."""
        loader, state, step = make_parts()
        state, _ = step(state, *next(iter(loader)))
        legacy = {'params': state.params, 'opt_state': state.opt_state,
                  'rng': state.rng, 'step': state.step}
        with Checkpointer(tmp_path, async_save=False) as checkpointer:
            checkpointer.save(IDENTITY, 1, legacy,
                              extras=ttrain.resume_extras(state, loader))
            _, blank, blank_step = blank_parts()
            restored, resumed_step, _ = checkpointer.resume(IDENTITY, blank)
            assert resumed_step == 1 and int(restored.step) == 1
            assert restored.health is None
            assert_same(state, restored)
            restored, _ = blank_step(restored, *next(iter(loader)))
            armed = ttrain.Guard().arm(restored)
            assert armed.health is not None
            _, other, _ = blank_parts()
            with pytest.raises(ValueError, match='health'):
                checkpointer.restore(IDENTITY, ttrain.Guard().arm(other),
                                     epoch=1)

    def test_discard_after_prunes_dead_branch_and_lowers_fence(
            self, tmp_path):
        loader, state, step = make_parts()
        with Checkpointer(tmp_path, async_save=False,
                          max_to_keep=None) as checkpointer:
            state, _ = drive(loader, state, step, checkpointer, until=6)
            assert checkpointer.fence(IDENTITY) == 6
            dead = checkpointer.discard_after(IDENTITY, 3)
            assert dead == [4, 5, 6]
            assert checkpointer.epochs(IDENTITY) == [1, 2, 3]
            assert checkpointer.fenced(IDENTITY) == 3
            checkpointer.save(IDENTITY, 4, state)
            assert checkpointer.latest(IDENTITY) == 4
