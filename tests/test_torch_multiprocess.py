"""Twins of ``tests/test_multiprocess.py``'s data-parallel tests: separate
port processes (torch, numpy and ``tpusystem_torch`` only) join one job
through ``Runtime(..., device='cpu')``: the TCP control plane and the
device plane (``torch.distributed`` over gloo, its store at the
coordinator's address) side by side. Wired events with primary-only
consumers, the collective agree, the barrier, and data-parallel steps over
the cross-process mesh; then a job that checkpoints, exits and resumes on
another world size. The reference's are ``slow``, and so are their twins;
one two-process run stays in the fast profile.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

WORKER = r'''
import json, sys
rank, nprocs = int(sys.argv[1]), int(sys.argv[2])
coordinator, out_path = sys.argv[3], sys.argv[4]

import numpy as np
import torch
torch.set_num_threads(1)

from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.parallel import MeshSpec, batch_sharding, replicated
from tpusystem_torch.runtime import Runtime
from tpusystem_torch.services import Consumer, event
from tpusystem_torch.train import (NextTokenLoss, SGD, build_train_step,
                                   init_state, module_apply)


@event
class Ping:
    sender: int


record = {'rank': rank}
with Runtime(coordinator=coordinator, num_processes=nprocs, process_id=rank,
             heartbeat=2.0, device='cpu') as runtime:
    record['is_primary'] = runtime.is_primary
    record['process_count'] = runtime.world.process_count
    record['group_size'] = torch.distributed.get_world_size()
    record['backend'] = torch.distributed.get_backend()

    received = []
    consumer = Consumer()

    @consumer.handler
    def on_ping(ping: Ping):
        received.append(ping.sender)

    runtime.producer.wire(Ping)
    runtime.producer.register(consumer, primary_only=True)
    runtime.barrier()
    if rank == nprocs - 1:
        runtime.producer.dispatch(Ping(sender=rank))
    runtime.barrier()
    runtime.sync()
    record['pings'] = received
    record['agree_none'] = runtime.should_stop(False)
    record['agree_one'] = runtime.should_stop(rank == 0)
    record['rank_sum'] = runtime.transport.allreduce(rank, op='sum')

    # data-parallel steps over the cross-process mesh: each process holds
    # its rows of the global batch, the parameters replicated
    mesh = MeshSpec(data=-1).build()
    record['mesh_size'] = mesh.size
    module = gpt2_tiny(attention='xla', dtype='float32', device='cpu')
    optimizer = SGD(lr=0.1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4 * nprocs, 32)))
    state = replicated(mesh)(init_state(module, optimizer))
    rows = batch_sharding(mesh)(tokens)
    step = build_train_step(module_apply(module), NextTokenLoss(), optimizer)
    state, (_, loss) = step(state, rows, rows)
    state, (_, loss2) = step(state, rows, rows)
    record['loss'] = float(loss)
    record['loss2'] = float(loss2)
    record['step'] = int(state.step)
    runtime.barrier()
record['left'] = not torch.distributed.is_initialized()

with open(out_path, 'w') as handle:
    json.dump(record, handle)
'''

RESUME_WORKER = r'''
import json, sys
rank, nprocs = int(sys.argv[1]), int(sys.argv[2])
coordinator, out_path = sys.argv[3], sys.argv[4]
ckpt_root = sys.argv[5]

import numpy as np
import torch
torch.set_num_threads(1)

from tpusystem_torch.checkpoint import Checkpointer
from tpusystem_torch.models import gpt2_tiny
from tpusystem_torch.parallel import MeshSpec, batch_sharding, replicated
from tpusystem_torch.registry import gethash
from tpusystem_torch.runtime import Runtime
from tpusystem_torch.train import (NextTokenLoss, SGD, build_train_step,
                                   init_state, module_apply)

record = {'rank': rank}
with Runtime(coordinator=coordinator, num_processes=nprocs, process_id=rank,
             heartbeat=2.0, device='cpu') as runtime:
    mesh = MeshSpec(data=-1).build()
    module = gpt2_tiny(attention='xla', dtype='float32', device='cpu')
    identity = gethash(module)           # the same on every process
    record['identity'] = identity
    optimizer = SGD(lr=0.1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (12, 32)))
    state = replicated(mesh)(init_state(module, optimizer))

    checkpointer = Checkpointer(ckpt_root)
    latest = checkpointer.latest(identity)
    record['start_epoch'] = 0 if latest is None else latest
    if latest is not None:
        # the saved state lands on THIS world's mesh
        state = checkpointer.restore(identity, state, latest)

    rows = batch_sharding(mesh)(tokens)
    step = build_train_step(module_apply(module), NextTokenLoss(), optimizer)
    losses = []
    for epoch in range(record['start_epoch'], record['start_epoch'] + 2):
        state, (_, loss) = step(state, rows, rows)
        losses.append(float(loss))
        checkpointer.save(identity, epoch + 1, state)   # every process
    checkpointer.wait()
    runtime.barrier()
    record['losses'] = losses
    record['end_step'] = int(state.step)

with open(out_path, 'w') as handle:
    json.dump(record, handle)
'''


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        return probe.getsockname()[1]


def _launch_workers(out_dir, source: str, nprocs: int, timeout: int,
                    extra_args: tuple = ()):
    """``nprocs`` port worker processes sharing one coordinator (the device
    plane's store) and one control-plane address; returns (procs, outputs)
    with every process reaped (killed if hung)."""
    coordinator = f'127.0.0.1:{_free_port()}'
    worker = out_dir / 'worker.py'
    worker.write_text(source)
    env = {key: value for key, value in os.environ.items()
           if not key.startswith('TPUSYSTEM_')}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1',
               TPUSYSTEM_CONTROL=f'127.0.0.1:{_free_port()}')
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(rank), str(nprocs), coordinator,
         str(out_dir / f'out{rank}.json'), *map(str, extra_args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(nprocs)]
    try:
        outputs = [proc.communicate(timeout=timeout)[0].decode()
                   for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return procs, outputs


def _unplaced_losses(nprocs: int) -> list:
    """The same two SGD steps on the whole batch in this process."""
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.train import (SGD, NextTokenLoss, build_train_step,
                                       init_state, module_apply)
    module = gpt2_tiny(attention='xla', dtype='float32', device='cpu')
    optimizer = SGD(lr=0.1)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4 * nprocs, 32)))
    state = init_state(module, optimizer)
    step = build_train_step(module_apply(module), NextTokenLoss(), optimizer)
    losses = []
    for _ in range(2):
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(float(loss))
    return losses


def _end_to_end(tmp_path, nprocs):
    procs, outputs = _launch_workers(tmp_path, WORKER, nprocs, timeout=240)
    for proc, output in zip(procs, outputs):
        assert proc.returncode == 0, f'worker failed:\n{output[-3000:]}'
    records = {rank: json.loads((tmp_path / f'out{rank}.json').read_text())
               for rank in range(nprocs)}
    for rank, record in records.items():
        assert record['process_count'] == nprocs
        assert record['group_size'] == record['mesh_size'] == nprocs
        assert record['backend'] == 'gloo'          # the CPU's backend
        assert record['is_primary'] == (rank == 0)
        assert record['agree_none'] is False
        assert record['agree_one'] is True
        assert record['rank_sum'] == nprocs * (nprocs - 1) // 2
        assert record['step'] == 2
        assert record['left']                       # close() left the group
    assert records[0]['pings'] == [nprocs - 1]
    assert all(records[rank]['pings'] == [] for rank in range(1, nprocs))
    # the DP step is SPMD: the global loss is identical everywhere, equal
    # to the whole batch's in one process, and training moved it
    losses = {(record['loss'], record['loss2']) for record in records.values()}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), _unplaced_losses(nprocs),
                               rtol=2e-5)
    assert records[0]['loss2'] < records[0]['loss']


def test_two_process_runtime_trains_through_the_device_plane(tmp_path):
    _end_to_end(tmp_path, 2)


@pytest.mark.slow
@pytest.mark.parametrize('nprocs', [2, 3, 8])
def test_multi_process_runtime_end_to_end(tmp_path, nprocs):
    _end_to_end(tmp_path, nprocs)


@pytest.mark.slow
def test_multi_process_checkpoint_restart_resume(tmp_path):
    """A two-process job trains two epochs with collective checkpoints (each
    process gathers, rank 0 writes), exits, and three fresh processes with
    the same identity resume from the last committed epoch on their own
    mesh and keep improving the loss."""
    ckpt_root = tmp_path / 'ckpt'

    def launch(run_dir, nprocs):
        run_dir.mkdir()
        procs, outputs = _launch_workers(run_dir, RESUME_WORKER, nprocs,
                                         timeout=240,
                                         extra_args=(ckpt_root,))
        for proc, output in zip(procs, outputs):
            assert proc.returncode == 0, f'worker failed:\n{output[-3000:]}'
        return {rank: json.loads((run_dir / f'out{rank}.json').read_text())
                for rank in range(nprocs)}

    first = launch(tmp_path / 'run1', nprocs=2)
    second = launch(tmp_path / 'run2', nprocs=3)
    for records in (first, second):
        assert len({record['identity'] for record in records.values()}) == 1
    assert all(r['start_epoch'] == 0 for r in first.values())
    assert all(r['start_epoch'] == 2 for r in second.values())
    assert all(r['end_step'] == 4 for r in second.values())
    assert second[0]['losses'][0] < first[0]['losses'][-1]
    assert second[0]['losses'][-1] < second[0]['losses'][0]
