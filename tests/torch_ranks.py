"""One rank of a gloo world for the port's multi-rank parity tests.

``python tests/torch_ranks.py RANK NPROCS COORDINATOR INPUTS OUTPUT``: joins
the job through ``tpusystem_torch.parallel.multihost.initialize`` (the
device plane on the CPU: gloo, its store at ``COORDINATOR``), runs every
scenario below on the inputs the test wrote (``INPUTS``, a pickle of numpy
arrays and the reference's weights as numpy trees) and pickles what this
rank saw to ``OUTPUT``. It imports torch, numpy and ``tpusystem_torch``
only; the test holds its results against the JAX package.
"""

from __future__ import annotations

import io
import pickle
import sys
import tempfile
from contextlib import redirect_stderr

import numpy as np
import torch


def _mlp(params, features, device='cpu'):
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import MLP
    module = MLP(features=features, classes=10, dropout=0.0, device=device)
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def mesh_layouts(out):
    """Axis sizes and this rank's coordinate on each mesh the tests use."""
    from tpusystem_torch.parallel import MeshSpec
    layouts = {}
    for name, spec in (('data', MeshSpec(data=-1)),
                       ('fsdp', MeshSpec(fsdp=-1)),
                       ('data_fsdp', MeshSpec(data=2, fsdp=2)),
                       ('data_model', MeshSpec(data=-1, model=2))):
        mesh = spec.build()
        layouts[name] = dict(shape=dict(mesh.shape),
                             coordinate=dict(mesh.coordinate),
                             device=str(mesh.device))
    out['layouts'] = layouts
    # a leaf split over the model axis: this rank's block of its columns
    from tpusystem_torch.parallel.mesh import PartitionSpec
    from tpusystem_torch.parallel.sharding import TensorParallel, local
    mesh = MeshSpec(data=-1, model=2).build()
    policy = TensorParallel([(r'kernel$', PartitionSpec(None, 'model'))])
    whole = torch.arange(24.0).reshape(4, 6)
    placed = policy.place({'kernel': whole}, mesh)['kernel']
    out['model_axis'] = local(placed).numpy()


def train_mlp(inputs, out):
    """DP and FSDP Adam steps of the MLP on the digits batch."""
    from tpusystem_torch.parallel import MeshSpec, batch_sharding
    from tpusystem_torch.parallel.sharding import (DataParallel,
                                                   FullyShardedDataParallel,
                                                   local)
    from tpusystem_torch.train import (Adam, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)
    images, labels = inputs['digits']
    for name, spec, policy in (
            ('dp', MeshSpec(data=-1), DataParallel()),
            ('fsdp', MeshSpec(fsdp=-1), FullyShardedDataParallel(min_size=64))):
        mesh = spec.build()
        module = _mlp(inputs['mlp'], (64,))
        optimizer = Adam(lr=1e-2)
        state = policy.place(init_state(module, optimizer, rng=0), mesh)
        step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                optimizer)
        rows = batch_sharding(mesh)
        losses = []
        for _ in range(4):
            state, (_, loss) = step(state, rows(images),
                                    rows(labels.astype(np.int64)))
            losses.append(float(loss))
        out[f'{name}_losses'] = losses
        out[f'{name}_shards'] = {key: tuple(local(leaf).shape)
                                 for key, leaf in state.params.items()}
        out[f'{name}_slot_shards'] = {
            key: tuple(local(leaf).shape)
            for key, leaf in state.opt_state['mu'].items()}


def collectives(out):
    """Every collective of the vocabulary on rank-dependent tensors."""
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel import collectives as c
    mesh = MeshSpec(data=-1).build()
    rank = mesh.axis_index('data')
    value = torch.arange(4.0)[rank:rank + 1]
    got = {
        'sum': c.all_reduce_sum(value, mesh, 'data'),
        'mean': c.all_reduce_mean(value, mesh, 'data'),
        'gather': c.all_gather(value, mesh, 'data'),
        'stacked': c.all_gather(value, mesh, 'data', tiled=False),
        'scatter': c.reduce_scatter(torch.ones(4), mesh, 'data'),
        'shift': c.ring_shift(value, mesh, 'data'),
        'back': c.ring_shift(value, mesh, 'data', reverse=True),
        'ring_gather': c.ring_allgather(
            torch.arange(6.0).reshape(2, 3) + 10 * rank, mesh, 'data',
            chunks=2),
        'gather_rows': c.all_gather(
            torch.arange(6.0).reshape(2, 3) + 10 * rank, mesh, 'data'),
        'ring_scatter': c.ring_reducescatter(
            torch.arange(16.0).reshape(8, 2) * (rank + 1), mesh, 'data'),
        'scatter_rows': c.reduce_scatter(
            torch.arange(16.0).reshape(8, 2) * (rank + 1), mesh, 'data'),
        'index': torch.tensor(float(c.axis_index(mesh, 'data'))),
        'size': torch.tensor(float(c.axis_size(mesh, 'data'))),
    }
    # the gradient of a gather is a reduce-scatter, and the reverse
    leaf = (torch.arange(3.0) + rank).requires_grad_()
    weights = torch.arange(12.0)
    (c.all_gather(leaf, mesh, 'data') * weights).sum().backward()
    got['gather_grad'] = leaf.grad
    wide = torch.ones(8, requires_grad=True)
    (c.reduce_scatter(wide, mesh, 'data') * (rank + 1)).sum().backward()
    got['scatter_grad'] = wide.grad
    pair = MeshSpec(data=2, fsdp=2).build()
    data = torch.arange(8.0).reshape(2, 4)[pair.axis_index('data')][None]
    got['all_to_all'] = c.all_to_all(data, pair, 'data', split_dimension=1,
                                      concat_dimension=0)
    flow = torch.arange(4.0, requires_grad=True)
    swapped = c.all_to_all(flow.reshape(1, 4), pair, 'data',
                           split_dimension=1, concat_dimension=0)
    (swapped * torch.tensor([[1.0, 2.0], [3.0, 4.0]])).sum().backward()
    got['all_to_all_grad'] = flow.grad
    out['collectives'] = {key: value.detach().numpy()
                          for key, value in got.items()}


def loader_rows(inputs, out):
    """This rank's rows of each batch, shuffled and not."""
    from tpusystem_torch.data.loader import ArrayDataset, Loader
    from tpusystem_torch.parallel import MeshSpec, batch_sharding
    mesh = MeshSpec(data=2, fsdp=2).build()
    features, targets = inputs['loader']
    rows = {}
    for shuffle in (False, True):
        loader = Loader(ArrayDataset(features, targets), 8, shuffle=shuffle,
                        seed=3, sharding=batch_sharding(mesh))
        rows[shuffle] = [[leaf.numpy() for leaf in batch]
                         for _ in range(2) for batch in loader]
    out['loader'] = rows


def masked_lm(inputs, out):
    """gpt2_tiny's masked NextTokenLoss under DP: the loss and the summed
    gradients, read through the step's ``fault=`` seam."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.parallel import MeshSpec, batch_sharding
    from tpusystem_torch.parallel.sharding import (DataParallel,
                                                   FullyShardedDataParallel,
                                                   gather_leaf)
    from tpusystem_torch.train import (SGD, NextTokenLoss, build_train_step,
                                       init_state, module_apply)
    tokens, targets = inputs['lm']
    for name, spec, policy in (
            ('dp', MeshSpec(data=-1), DataParallel()),
            ('fsdp', MeshSpec(fsdp=-1), FullyShardedDataParallel(min_size=64))):
        mesh = spec.build()
        module = gpt2_tiny(attention='xla', dtype='float32', device='cpu')
        module.load_state_dict(params_from_jax(inputs['gpt2']), strict=True)
        optimizer = SGD(lr=0.1)
        state = policy.place(init_state(module, optimizer, rng=0), mesh)
        seen = {}

        def fault(step, grads, loss):
            seen['grads'] = {key: grad.detach().clone()
                             for key, grad in grads.items()}
            return grads, loss

        step = build_train_step(module_apply(module), NextTokenLoss(),
                                optimizer, fault=fault)
        rows = batch_sharding(mesh)
        placed = dict(state.params)
        state, (_, loss) = step(state, rows(tokens), rows(targets))
        with torch.no_grad():      # an FSDP rank holds its pieces: gather
            whole = {key: gather_leaf(grad, placed[key], mesh).numpy()
                     for key, grad in seen['grads'].items()}
        out[f'lm_{name}'] = dict(loss=float(loss), grads=whole)


def parity(inputs, out):
    """Replica checksums and check_parity on two meshes, a flipped bit on
    one replica, and the check ahead of a checkpoint commit."""
    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.observe.events import ReplicaDiverged
    from tpusystem_torch.parallel import FlipParamBit, MeshSpec, replicated
    from tpusystem_torch.parallel.collectives import replica_checksums
    from tpusystem_torch.parallel.recovery import DivergenceError
    from tpusystem_torch.services import Consumer, Producer
    from tpusystem_torch.train import Adam, Sentinel, init_state
    results = {}
    for name, spec in (('data4', MeshSpec(data=4)),
                       ('data2_model2', MeshSpec(data=2, model=2))):
        mesh = spec.build()
        state = replicated(mesh)(init_state(
            _mlp(inputs['parity'], (16,)), Adam(lr=1e-2), rng=1))
        clean, paths = replica_checksums(state.params, mesh)
        flip = inputs['flips'][name]
        FlipParamBit(replica=flip['replica'], leaf=flip['leaf'],
                     index=flip['index'], bit=flip['bit'])(state.params, mesh)
        flipped, _ = replica_checksums(state.params, mesh)
        verdict = Sentinel().check_parity(state, mesh,
                                          raise_on_mismatch=False)
        results[name] = dict(clean=clean, flipped=flipped, paths=paths,
                             verdict=verdict)
    # the acceptance scenario: the check sits between the step and the save
    mesh = MeshSpec(data=4).build()
    state = replicated(mesh)(init_state(_mlp(inputs['parity'], (16,)),
                                        Adam(lr=1e-2), rng=1))
    producer, seen = Producer(), []
    consumer = Consumer()
    consumer.register(ReplicaDiverged, seen.append)
    producer.register(consumer)
    sentinel = Sentinel(producer=producer, model='sdc-drill')
    with Checkpointer(inputs['root'], async_save=False) as checkpointer:
        clean = sentinel.check_parity(state, mesh) is None
        checkpointer.save('sdc', 1, state)      # a clean step commits
        torch.distributed.barrier()
        flip = inputs['flips']['drill']
        FlipParamBit(replica=flip['replica'], leaf=flip['leaf'],
                     index=flip['index'], bit=flip['bit'])(state.params, mesh)
        try:
            sentinel.check_parity(state, mesh)
            raised = None
        except DivergenceError as error:
            raised = str(error)
        latest = checkpointer.latest('sdc')
    results['drill'] = dict(clean=clean, raised=raised, latest=latest,
                            replicas=[event.replicas for event in seen])
    out['parity'] = results


def checkpoints(inputs, out):
    """A state saved whole restores onto replicated and FSDP placements; a
    placed state's pieces reshard onto other boundaries bit for bit."""
    from torch.distributed.tensor import Replicate

    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.checkpoint.memstore import ShardedLeaf
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.sharding import (DataParallel,
                                                   FullyShardedDataParallel,
                                                   held_slices, local)
    from tpusystem_torch.train import Adam, init_state
    rank = torch.distributed.get_rank()
    saved = init_state(_mlp(inputs['mlp'], (64,)), Adam(lr=1e-2), rng=0)
    whole = {key: leaf.detach().clone() for key, leaf in saved.params.items()}
    root = inputs['root']
    if rank == 0:
        with Checkpointer(root, async_save=False) as checkpointer:
            checkpointer.save('m', 0, saved)
    torch.distributed.barrier()
    report = {}
    for name, spec, policy in (
            ('replicated', MeshSpec(data=4), DataParallel()),
            ('fsdp', MeshSpec(fsdp=4), FullyShardedDataParallel(min_size=64))):
        mesh = spec.build()
        from tpusystem_torch.models import MLP
        target = init_state(MLP(features=(64,), classes=10, dropout=0.0,
                                device='cpu'), Adam(lr=1e-2), rng=5)
        target = policy.place(target, mesh)
        with Checkpointer(root, async_save=False) as checkpointer:
            restored = checkpointer.restore('m', target)
        first = next(iter(restored.params))
        leaf = restored.params[first]
        report[name] = dict(
            replicated=all(isinstance(p, Replicate) for p in leaf.placements),
            equal=all(torch.equal(local(piece), whole[key][held_slices(piece)])
                      for key, piece in restored.params.items()),
            shape=tuple(local(leaf).shape))
    # ShardedLeaf: fsdp=4 pieces merged, placed on a data=2 x fsdp=2 layout
    mesh = MeshSpec(fsdp=4).build()
    placed = FullyShardedDataParallel(min_size=64).place(
        init_state(_mlp(inputs['mlp'], (64,)), Adam(), rng=0), mesh)
    mine = {key: ShardedLeaf.from_tensor(leaf)
            for key, leaf in placed.params.items()}
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, mine)
    merged = {key: everyone[0][key] for key in mine}
    for pieces in everyone[1:]:
        merged = {key: merged[key].merged(pieces[key]) for key in merged}
    other = MeshSpec(data=2, fsdp=2).build()
    target = FullyShardedDataParallel(min_size=64).place(
        init_state(_mlp(inputs['mlp'], (64,)), Adam(), rng=0), other)
    exact, refused = True, True
    for key, piece in merged.items():
        leaf = target.params[key]
        moved = piece.place(leaf, reshard=True)
        exact &= torch.equal(local(moved), whole[key][held_slices(leaf)])
        if held_slices(leaf) != held_slices(placed.params[key]):
            try:
                ShardedLeaf.from_tensor(placed.params[key]).place(leaf)
                refused = False
            except ValueError:
                pass
    report['reshard'] = dict(exact=bool(exact), refused=refused,
                             pieces=len(merged['Dense_0.weight'].shards))
    # a state placed on a mesh over ranks 1-3 (rank 0 outside it): the
    # mesh's first rank writes it
    from tpusystem_torch.models import MLP
    torch.manual_seed(3)
    module = MLP(features=(48,), classes=10, dropout=0.0, device='cpu')
    whole = {key: leaf.detach().clone()
             for key, leaf in module.named_parameters()}
    sub = MeshSpec(fsdp=3).build(ranks=[1, 2, 3])
    shards = None
    if rank != 0:
        placed = FullyShardedDataParallel(min_size=64).place(
            init_state(module, Adam(), rng=0), sub)
        shards = {key: tuple(local(leaf).shape)
                  for key, leaf in placed.params.items()}
        with Checkpointer(root, async_save=False) as checkpointer:
            checkpointer.save('sub', 0, placed)
    torch.distributed.barrier()
    target = init_state(MLP(features=(48,), classes=10, dropout=0.0,
                            device='cpu'), Adam(), rng=5)
    with Checkpointer(root, async_save=False) as checkpointer:
        latest = checkpointer.latest('sub')
        restored = checkpointer.restore('sub', target)
    report['submesh'] = dict(
        latest=latest, shards=shards,
        equal=all(torch.equal(restored.params[key], value)
                  for key, value in whole.items()))
    out['checkpoint'] = report


def resnet(inputs, out):
    """One AdamW step of resnet_tiny under DataParallel over every rank."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import resnet_tiny
    from tpusystem_torch.parallel import MeshSpec, batch_sharding
    from tpusystem_torch.parallel.sharding import DataParallel
    from tpusystem_torch.train import (AdamW, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)
    images, labels = inputs['images']
    mesh = MeshSpec(data=-1).build()
    module = resnet_tiny(device='cpu')
    module.load_state_dict(params_from_jax(inputs['resnet']), strict=True)
    optimizer = AdamW(lr=1e-3)
    state = DataParallel().place(init_state(module, optimizer), mesh)
    step = build_train_step(module_apply(module), CrossEntropyLoss(),
                            optimizer)
    rows = batch_sharding(mesh)
    state, (_, loss) = step(state, rows(images), rows(labels))
    out['resnet_loss'] = float(loss)


def guarded(inputs, out):
    """Two guarded, clipped AdamW steps per call of ``build_multi_step``
    under FSDP over every rank, and the same steps unplaced in this
    process: the loss and health rows (the grad norm summed over the
    ranks' own pieces) for the test to compare."""
    from tpusystem_torch.parallel import MeshSpec, stacked_batch_sharding
    from tpusystem_torch.parallel.sharding import FullyShardedDataParallel
    from tpusystem_torch.train import (AdamW, CrossEntropyLoss, Guard,
                                       build_multi_step, build_train_step,
                                       init_state, module_apply)
    images, labels = inputs['digits']
    stack = (torch.from_numpy(images).reshape(2, 32, 28, 28),
             torch.from_numpy(labels.astype(np.int64)).reshape(2, 32))
    results = {}
    for name in ('unplaced', 'fsdp'):
        module = _mlp(inputs['mlp'], (64,))
        optimizer = AdamW(lr=1e-2, grad_clip=0.5)
        guard = Guard()
        state = guard.arm(init_state(module, optimizer, rng=0))
        batch = stack
        if name == 'fsdp':
            mesh = MeshSpec(fsdp=-1).build()
            state = FullyShardedDataParallel(min_size=64).place(state, mesh)
            batch = stacked_batch_sharding(mesh)(stack)
        multi = build_multi_step(build_train_step(
            module_apply(module), CrossEntropyLoss(), optimizer, guard=guard),
            guard=True)
        rows = []
        for _ in range(2):
            state, (losses, health) = multi(state, *batch)
            rows.append(health.numpy())
        results[name] = np.concatenate(rows)
    out['guarded'] = results


# ---------------------------------------------------------------------------
# elastic resharding across ranks (twins of tests/test_elastic.py's
# TestResharding and TestWaveDrill, tests/test_chaos.py's TestBuddyDoubleLoss)


def _wait_until(predicate, timeout=20.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def resharding(inputs, out):
    """Four data-sharded pieces of one array, split over two 'hosts',
    merged and placed on data=2 slice boundaries."""
    from tpusystem_torch.checkpoint.memstore import ShardedLeaf
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.mesh import PartitionSpec
    from tpusystem_torch.parallel.sharding import (ShardingPolicy,
                                                   held_slices, local)
    policy = ShardingPolicy(rules=[(r'x$', PartitionSpec('data'))])
    values = torch.arange(64, dtype=torch.float32).reshape(8, 8) * 1.37
    sharded = policy.place({'x': values}, MeshSpec(data=4).build())['x']
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone,
                                        ShardedLeaf.from_tensor(sharded))
    whole = everyone[0]
    for piece in everyone[1:]:
        whole = whole.merged(piece)
    keys = sorted(whole.shards)
    hosts = [ShardedLeaf(whole.shape, whole.dtype,
                         {key: whole.shards[key] for key in keys[:2]}),
             ShardedLeaf(whole.shape, whole.dtype,
                         {key: whole.shards[key] for key in keys[2:]})]
    merged = hosts[0].merged(hosts[1])
    target = policy.place({'x': torch.zeros(8, 8)},
                          MeshSpec(data=2, fsdp=2).build())['x']
    errors = {}
    for name, call in (('exact', lambda: merged.place(target)),
                       ('one_host', lambda: hosts[0].place(target,
                                                           reshard=True))):
        try:
            call()
            errors[name] = None
        except ValueError as error:
            errors[name] = str(error)
    placed = merged.place(target, reshard=True)
    out['resharding'] = dict(
        pieces=len(merged.shards), errors=errors,
        exact=bool(torch.equal(local(placed), values[held_slices(target)])),
        placements=[str(p) for p in placed.placements] == [
            str(p) for p in target.placements])


def _drill_cell(mesh, seed):
    """One training cell: gpt2_tiny (2 layers, dim 32) placed by its TP
    rules with FSDP (every rank holds unique pieces), AdamW, a batch."""
    from tpusystem_torch.models import GPT2, gpt2_tiny
    from tpusystem_torch.parallel import TensorParallel, batch_sharding
    from tpusystem_torch.train import (AdamW, NextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)
    module = gpt2_tiny(layers=2, dim=32, heads=2, max_seq=32, device='cpu')
    optimizer = AdamW(lr=1e-3)
    policy = TensorParallel(GPT2.partition_rules(), fsdp=True,
                            fsdp_min_size=16)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (4, 16)))

    def blank(target_mesh):
        fresh = gpt2_tiny(layers=2, dim=32, heads=2, max_seq=32,
                          device='cpu')
        return policy.place(init_state(fresh, optimizer), target_mesh)

    state = policy.place(init_state(module, optimizer), mesh)
    step = build_train_step(module_apply(module), NextTokenLoss(), optimizer)
    return state, step, batch_sharding(mesh)(tokens), blank, tokens


def _control_plane(rank, size, seed=None):
    """The hub on rank 0, its address broadcast over the device plane; a
    ChaosTransport, a Supervisor (buddy ``rank ^ 1``) and a MemStoreClient
    on every rank."""
    from tpusystem_torch.checkpoint.memstore import MemStoreClient
    from tpusystem_torch.parallel import ChaosTransport, Faults, Hub, Supervisor
    hub = Hub(size) if rank == 0 else None
    address = [hub.address if hub is not None else None]
    torch.distributed.broadcast_object_list(address, src=0)
    transport = ChaosTransport(tuple(address[0]), rank, size,
                               **({} if seed is None
                                  else {'faults': Faults(seed=seed)}))
    if hub is not None:
        assert _wait_until(lambda: len(hub._clients) == size)
    torch.distributed.barrier()
    supervisor = Supervisor(['w'], rank=rank, transport=transport,
                            buddy=rank ^ 1)
    client = MemStoreClient(supervisor.server.address)
    return hub, tuple(address[0]), transport, supervisor, client


def _same(left, right) -> bool:
    from tpusystem_torch.checkpoint.checkpointer import flatten_state
    from tpusystem_torch.parallel.sharding import local
    for (_, a), (_, b) in zip(flatten_state(left), flatten_state(right)):
        if isinstance(a, torch.Tensor):
            if not torch.equal(local(a), local(b)):
                return False
        elif a != b:
            return False
    return True


def wave_drill(inputs, out):
    """Kill two of four hosts mid-run, resize once, reshard hot pieces
    onto the two survivors' mesh bit for bit the disk restore, train on,
    grow back to three."""
    import time

    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.observe.events import (ElasticTimeline,
                                                WorldResized)
    from tpusystem_torch.parallel import MeshSpec, TcpTransport
    from tpusystem_torch.parallel.chaos import PreemptionWave
    from tpusystem_torch.parallel.elastic import (ElasticCoordinator,
                                                  ElasticPolicy,
                                                  collect_pieces,
                                                  elastic_resume,
                                                  split_pieces)
    from tpusystem_torch.services import Consumer, Producer
    identity, die_at, survivors = 'elastic-drill', 2, (0, 2)
    rank = torch.distributed.get_rank()
    spec = MeshSpec(fsdp=4)
    mesh4 = spec.build()
    hub, address, transport, supervisor, client = _control_plane(rank, 4)
    producer, seen = Producer(), []
    consumer = Consumer()
    for kind in (WorldResized, ElasticTimeline):
        consumer.register(kind, seen.append)
    producer.register(consumer)
    policy = ElasticPolicy(settle_window=0.25, rebroadcast=0.1)
    coord = ElasticCoordinator(transport, rank, 4, policy=policy,
                               producer=producer if rank == 0 else None,
                               on_resize=None).start()
    checkpointer = Checkpointer(inputs['root'] + '/wave', async_save=False)
    record = {}
    extra = None
    try:
        state, step, rows, blank, tokens = _drill_cell(mesh4, 0)
        wave = PreemptionWave(step=die_at, kills=(
            (transport.kill,) if rank in (1, 3) else ()))
        while int(state.step) < die_at:
            state, _ = step(state, rows, rows)
            at = int(state.step)
            checkpointer.save(identity, at, state, extras={'step': at})
            blobs = split_pieces(state, mesh4, 4)     # every host's pieces
            client.push(identity, at, blobs[rank], extras={'step': at})
            if at == die_at:
                # the wave must not beat the step's buddy replicas
                if rank in survivors:
                    assert _wait_until(lambda: (held := supervisor.store.newest(
                        identity, replica=True)) is not None
                        and held.step == die_at)
                torch.distributed.barrier()
            wave(at)
        record['fired'] = wave.fired
        if rank in survivors:
            assert _wait_until(lambda: bool(coord.decisions))
            time.sleep(3 * policy.settle_window)     # no second epoch
            record['decisions'] = [(d.epoch, d.members)
                                   for d in coord.decisions]
            record['buddy_of_0'] = coord.decisions[0].buddy_of(0)
        mesh2 = spec.resized(2).build(ranks=list(survivors))
        if rank in survivors:
            target = blank(mesh2)
            pieces = collect_pieces(identity, rank=rank, members=range(4),
                                    survivors=survivors,
                                    store=supervisor.store,
                                    transport=transport,
                                    buddy_of=lambda member: member ^ 1)
            record['pieces'] = len(pieces)
            restored, at, extras, source = elastic_resume(
                checkpointer, identity, target, pieces)
            record.update(source=source, at=at, extras=extras)
            disk = checkpointer.restore(identity, blank(mesh2), epoch=die_at)
            record['bitwise'] = _same(restored, disk)
            rows2 = batch_sharding_of(mesh2)(tokens)
            restored, (_, loss) = step(restored, rows2, rows2)
            record.update(loss=float(loss), step=int(restored.step))
            if rank == 0:
                coord.resumed(step=int(restored.step), source='hot-reshard')
        torch.distributed.barrier()
        # a returning host grows the world back
        if rank == 0:
            hub.readmit(3)
        torch.distributed.barrier()
        if rank == 3:
            replacement = TcpTransport(address, 3, 4)
            extra = (replacement, ElasticCoordinator(
                replacement, 3, policy=policy, members=None).start())
        growing = extra[1] if extra is not None else coord
        if rank in (0, 2, 3):
            assert _wait_until(lambda: growing.decisions and
                               growing.decisions[-1].epoch == 2)
            record['grown'] = growing.decisions[-1].members
        torch.distributed.barrier()
        if rank == 0:
            record['resized'] = [event.size for event in seen
                                 if isinstance(event, WorldResized)]
            record['timelines'] = [(event.source, event.size) for event in seen
                                   if isinstance(event, ElasticTimeline)]
    finally:
        if extra is not None:
            extra[1].close()
            extra[0].close()
        client.close()
        coord.close()
        supervisor.close()
        checkpointer.close()
        transport.close()
        torch.distributed.barrier()
        if hub is not None:
            hub.close()
    out['wave'] = record


def batch_sharding_of(mesh):
    from tpusystem_torch.parallel import batch_sharding
    return batch_sharding(mesh)


def double_loss(inputs, out):
    """A buddy pair dies in one wave: the hot tier cannot cover their
    pieces, the resize falls back to disk bit for bit and trains on
    identically."""
    import logging

    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.chaos import PreemptionWave
    from tpusystem_torch.parallel.elastic import (ElasticCoordinator,
                                                  ElasticPolicy,
                                                  collect_pieces,
                                                  elastic_resume,
                                                  split_pieces)
    identity, die_at, survivors = 'double-loss', 2, (0, 1)
    rank = torch.distributed.get_rank()
    spec = MeshSpec(fsdp=4)
    mesh4 = spec.build()
    hub, address, transport, supervisor, client = _control_plane(
        rank, 4, seed=rank)
    policy = ElasticPolicy(settle_window=0.25, rebroadcast=0.1)
    coord = (ElasticCoordinator(transport, rank, 4, policy=policy).start()
             if rank in survivors else None)
    checkpointer = Checkpointer(inputs['root'] + '/double',
                                async_save=False)
    messages: list = []

    class Keep(logging.Handler):
        def emit(self, entry):
            messages.append(entry.getMessage())

    handler = Keep(logging.WARNING)
    logging.getLogger('tpusystem_torch').addHandler(handler)
    record = {}
    try:
        state, step, rows, blank, tokens = _drill_cell(mesh4, 1)
        # ranks 2 and 3 ARE a buddy pair: one wave takes both copies
        wave = PreemptionWave(step=die_at, kills=(
            (transport.kill,) if rank in (2, 3) else ()))
        while int(state.step) < die_at:
            state, _ = step(state, rows, rows)
            at = int(state.step)
            checkpointer.save(identity, at, state, extras={'step': at})
            blobs = split_pieces(state, mesh4, 4)
            client.push(identity, at, blobs[rank], extras={'step': at})
            torch.distributed.barrier()
            wave(at)
        record['fired'] = wave.fired
        if rank in survivors:
            assert _wait_until(lambda: bool(coord.decisions))
            record['decisions'] = [(d.epoch, d.members)
                                   for d in coord.decisions]
        mesh2 = spec.resized(2).build(ranks=list(survivors))
        if rank in survivors:
            pieces = collect_pieces(identity, rank=rank, members=range(4),
                                    survivors=survivors,
                                    store=supervisor.store,
                                    transport=transport,
                                    buddy_of=lambda member: member ^ 1)
            record['pieces'] = len(pieces)
            restored, at, extras, source = elastic_resume(
                checkpointer, identity, blank(mesh2), pieces)
            record.update(source=source, at=at)
            disk = checkpointer.restore(identity, blank(mesh2), epoch=die_at)
            record['bitwise'] = _same(restored, disk)
            rows2 = batch_sharding_of(mesh2)(tokens)
            _, (_, resumed) = step(restored, rows2, rows2)
            _, (_, reference) = step(disk, rows2, rows2)
            record.update(resumed=float(resumed), reference=float(reference))
            record['warnings'] = messages
    finally:
        logging.getLogger('tpusystem_torch').removeHandler(handler)
        client.close()
        if coord is not None:
            coord.close()
        supervisor.close()
        checkpointer.close()
        transport.close()
        torch.distributed.barrier()
        if hub is not None:
            hub.close()
    out['double_loss'] = record


# ---------------------------------------------------------------------------
# tensor parallelism (twins of tests/test_overlap.py, tests/test_schedule.py,
# tests/test_parallel.py:138,151 and tests/test_serve_disagg.py's TP cases)


def _dtype(name):
    return {'float32': torch.float32, 'bfloat16': torch.bfloat16}[name]


def _numpy(tensor):
    return tensor.detach().float().numpy()


def overlap_rings(inputs, out):
    """allgather_matmul and matmul_reducescatter over ``model=4`` on the
    test's operands at chunks 1-3 in float32 and bfloat16: each rank's
    output block and gradient pieces of ``sum(y^2)``; and the ring shift
    over both routes, bit for bit."""
    from tpusystem_torch.parallel import (MeshSpec, allgather_matmul,
                                          matmul_reducescatter)
    from tpusystem_torch.parallel.collectives import (ring_shift,
                                                      ring_shift_chunked)
    mesh = MeshSpec(model=4).build()
    rank, n = mesh.axis_index('model'), 4
    found = {}
    for name, (x, w) in inputs['overlap'].items():
        x, w = (torch.from_numpy(a).to(_dtype(name)) for a in (x, w))
        for kind, fn, x_dim, w_dim in (('ag', allgather_matmul, 0, 1),
                                       ('rs', matmul_reducescatter, 1, 0)):
            for chunks in (1, 2, 3):
                xs = x.chunk(n, x_dim)[rank].clone().requires_grad_()
                ws = w.chunk(n, w_dim)[rank].clone().requires_grad_()
                y = fn(xs, ws, mesh, 'model', chunks=chunks)
                y.float().square().sum().backward()
                found[name, kind, chunks] = dict(
                    y=_numpy(y), dx=_numpy(xs.grad), dw=_numpy(ws.grad),
                    dtypes=(str(y.dtype), str(xs.grad.dtype),
                            str(ws.grad.dtype)))
    out['overlap'] = found
    # the ring shift's two routes: the same bits, forward and backward
    shifts = {}
    for route in ('p2p', 'gather'):
        mesh.route = route
        value = (torch.arange(24.0).reshape(4, 6) * 1.37 + 100 * rank)
        got = []
        for dtype in (torch.float32, torch.bfloat16):
            leaf = value.to(dtype).detach().clone().requires_grad_()
            moved = (ring_shift(leaf, mesh, 'model'),
                     ring_shift(leaf, mesh, 'model', reverse=True),
                     ring_shift_chunked(leaf, mesh, 'model', chunks=2))
            sum(part.float() * (index + 2) for index, part in
                enumerate(moved)).sum().backward()
            got += [part.detach() for part in moved] + [leaf.grad]
        shifts[route] = got
    mesh.route = 'p2p'
    out['routes'] = dict(
        default=MeshSpec(model=4).build().route,
        bitwise=all(torch.equal(a, b) and a.dtype == b.dtype for a, b in
                    zip(shifts['p2p'], shifts['gather'])),
        held=[_numpy(part) for part in shifts['gather']])


def _ffn_params(operands, dtype):
    names = ('x', 'fc.kernel', 'fc.bias', 'proj.kernel', 'proj.bias')
    return {name: torch.from_numpy(array).to(dtype)
            for name, array in zip(names, operands)}


def _ffn_case(mesh, schedule, operands, dtype, grads=True):
    """scheduled_ffn on this rank's pieces, placed as the step places them
    (the FFN's TP rules and FSDP at min size 64; the kernels kept split
    over fsdp under prefetch): this rank's output rows and, with
    ``grads``, the whole gradients of ``sum(out^2) * 1e-3`` (x's as this
    rank's rows)."""
    from tpusystem_torch.parallel import batch_sharding, scheduled_ffn
    from tpusystem_torch.parallel.mesh import PartitionSpec as P
    from tpusystem_torch.parallel.sharding import (ShardingPolicy,
                                                   gather_leaf, local)
    from tpusystem_torch.train.step import sync_grads
    params = _ffn_params(operands, dtype)
    x = batch_sharding(mesh)(params.pop('x')).requires_grad_()
    placed = ShardingPolicy(rules=((r'fc/kernel$', P(None, 'model')),
                                   (r'proj/kernel$', P('model', None))),
                            fsdp=True, fsdp_min_size=64).place(params, mesh)
    names = list(placed)
    leaves = [local(placed[name]).detach().requires_grad_()
              for name in names]
    keep = {name: (('model', 'fsdp') if schedule.fsdp == 'prefetch'
                   and name.endswith('kernel') else ('model',))
            for name in names}
    given = [gather_leaf(leaf, placed[name], mesh, keep[name])
             for name, leaf in zip(names, leaves)]
    result = scheduled_ffn(x, *given, mesh, schedule=schedule)
    record = dict(out=_numpy(result), dtype=str(result.dtype))
    if grads:
        loss = result.float().square().sum() * 1e-3
        found = torch.autograd.grad(loss, [x] + leaves)
        synced = sync_grads(list(found[1:]), [placed[n] for n in names],
                            mesh)
        with torch.no_grad():
            record['grads'] = {name: _numpy(gather_leaf(grad, placed[name],
                                                        mesh))
                               for name, grad in zip(names, synced)}
        record['grads']['x'] = _numpy(found[0])
        record['grad_dtypes'] = {name: str(grad.dtype)
                                 for name, grad in zip(names, synced)}
    return record


def schedule_rings(inputs, out):
    """The FSDP rings and the scheduled FFN on the fsdp=4 and the composed
    fsdp=2 x model=2 meshes, each case as the reference's test runs it."""
    from tpusystem_torch.parallel import (MeshSpec, OverlapSchedule,
                                          ring_allgather, ring_reducescatter)
    from tpusystem_torch.parallel.collectives import all_gather
    fsdp = MeshSpec(fsdp=4).build()
    rank = fsdp.axis_index('fsdp')
    value = torch.from_numpy(inputs['ring_value'])
    rings = {}
    for dim, chunks in ((0, 1), (0, 2), (1, 1)):
        shard = value.chunk(4, dim)[rank]
        ring = ring_allgather(shard, fsdp, 'fsdp', dimension=dim,
                              chunks=chunks)
        rings['gather', dim, chunks] = torch.equal(
            ring, all_gather(shard, fsdp, 'fsdp', dimension=dim))
        stacked = torch.from_numpy(inputs['ring_values'][rank])
        rings['scatter', dim, chunks] = _numpy(ring_reducescatter(
            stacked, fsdp, 'fsdp', dimension=dim, chunks=chunks))
    composed = MeshSpec(fsdp=2, model=2).build()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {}
    for chunks in (1, 2):
        cases['prefetch', chunks] = _ffn_case(fsdp, OverlapSchedule(
            fsdp='prefetch', chunks=chunks, fsdp_min_size=64),
            inputs['ffn'], f32, grads=chunks == 2)
        cases['composed', chunks] = _ffn_case(composed, OverlapSchedule(
            tp='overlap', fsdp='prefetch', chunks=chunks, fsdp_min_size=64),
            inputs['ffn'], f32)
    cases['monolithic'] = _ffn_case(fsdp, OverlapSchedule(fsdp_min_size=64),
                                    inputs['ffn'], f32, grads=False)
    cases['bf16'] = _ffn_case(composed, OverlapSchedule(
        tp='overlap', fsdp='prefetch', chunks=1, fsdp_min_size=64),
        inputs['ffn_bf16'], bf16)
    cases['one-shot'] = _ffn_case(fsdp, OverlapSchedule(
        fsdp='prefetch', chunks=3, fsdp_min_size=64), inputs['ffn'], f32)
    cases['row-split'] = _ffn_case(composed, OverlapSchedule(
        tp='overlap', fsdp='prefetch', chunks=32, fsdp_min_size=64),
        inputs['ffn96'], f32)
    out['schedule'] = dict(rings=rings, cases=cases)


def _lm(family: str, params, **knobs):
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import GPT2, llama_tiny
    if family == 'gpt2':
        module = GPT2(vocab_size=256, layers=2, dim=64, heads=4, max_seq=128,
                      dropout=0.0, dtype='float32', device='cpu', **knobs)
    else:
        module = llama_tiny(dtype='float32', device='cpu', **knobs)
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def tp_forward(module, mesh, tokens, policy, grads=True):
    """``module`` over the mesh as the placed step runs it: its weights
    placed by ``policy``, each handed to the forward as
    :meth:`keeps_split` asks, this rank's rows of ``tokens``; returns this
    rank's logits and, with ``grads``, the whole gradients of
    ``sum(logits^2) * 1e-3`` summed over the batch axes."""
    from torch.func import functional_call

    from tpusystem_torch.parallel import batch_sharding
    from tpusystem_torch.parallel.sharding import gather_leaf, local
    from tpusystem_torch.train.step import sync_grads
    weights = {name: leaf.detach().clone()
               for name, leaf in module.named_parameters()}
    placed = policy.place(weights, mesh)
    names = list(placed)
    leaves = [local(placed[name]).detach().requires_grad_()
              for name in names]
    given = {name: gather_leaf(leaf, placed[name], mesh,
                               module.keeps_split(name))
             for name, leaf in zip(names, leaves)}
    rows = batch_sharding(mesh)(torch.from_numpy(tokens).long())
    logits = functional_call(module, given, (rows,))
    record = dict(logits=_numpy(logits),
                  shards={name: tuple(local(placed[name]).shape)
                          for name in names})
    if grads:
        loss = logits.float().square().sum() * 1e-3
        found = torch.autograd.grad(loss, leaves)
        synced = sync_grads(list(found), [placed[n] for n in names], mesh)
        with torch.no_grad():
            record['grads'] = {name: _numpy(gather_leaf(grad, placed[name],
                                                        mesh))
                               for name, grad in zip(names, synced)}
    return record


def tp_impl(inputs, out):
    """GPT-2 and Llama over data=2 x model=2 under ``tp_impl`` 'gspmd' and
    'overlap', and GPT-2 at a sequence the ring cannot split."""
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.sharding import ShardingPolicy
    mesh = MeshSpec(data=2, model=2).build()
    found = {}
    for family in ('gpt2', 'llama'):
        params = inputs[family]
        policy = ShardingPolicy(rules=_lm(family, params).partition_rules())
        for impl in ('gspmd', 'overlap'):
            found[family, impl] = tp_forward(
                _lm(family, params, mesh=mesh, tp_impl=impl, tp_chunks=2),
                mesh, inputs['tokens'], policy)
    policy = ShardingPolicy(rules=_lm('gpt2', inputs['gpt2']).partition_rules())
    for impl in ('gspmd', 'overlap'):
        found['seq15', impl] = tp_forward(
            _lm('gpt2', inputs['gpt2'], mesh=mesh, tp_impl=impl), mesh,
            inputs['tokens15'], policy, grads=False)
    out['tp_impl'] = found


def tp_schedule(inputs, out):
    """GPT-2 and Llama over fsdp=2 x model=2 with and without
    ``schedule=``, the scanned GPT-2, and a checkpoint saved before the
    knob restored under it."""
    from tpusystem_torch.checkpoint import Checkpointer
    from tpusystem_torch.parallel import MeshSpec, OverlapSchedule
    from tpusystem_torch.parallel.sharding import ShardingPolicy
    from tpusystem_torch.train import AdamW, init_state
    mesh = MeshSpec(fsdp=2, model=2).build()
    schedule = OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=2,
                               fsdp_min_size=64)
    found = {}
    for family in ('gpt2', 'llama'):
        params = inputs[family]
        policy = ShardingPolicy(rules=_lm(family, params).partition_rules(),
                                fsdp=True, fsdp_min_size=64)
        for name, knob in (('none', None), ('schedule', schedule)):
            found[family, name] = tp_forward(
                _lm(family, params, mesh=mesh, schedule=knob), mesh,
                inputs['tokens'], policy)
    policy = ShardingPolicy(rules=_lm('gpt2', inputs['gpt2']).partition_rules(),
                            fsdp=True, fsdp_min_size=64)
    for name, knob in (('none', None), ('schedule', schedule)):
        found['scan', name] = tp_forward(
            _lm('gpt2', inputs['gpt2_scan'], mesh=mesh, schedule=knob,
                scan_layers=True), mesh, inputs['tokens2'], policy,
            grads=False)
    # a checkpoint written by the model without the knob, restored under it
    old = _lm('gpt2', inputs['gpt2_ckpt'], mesh=mesh)
    state = init_state(old, AdamW(lr=1e-3), rng=0)
    root = inputs['root'] + '/pre-schedule'
    if torch.distributed.get_rank() == 0:
        with Checkpointer(root, async_save=False) as checkpointer:
            checkpointer.save('pre-schedule', 0, state)
    torch.distributed.barrier()
    blank = init_state(_lm('gpt2', inputs['gpt2']), AdamW(lr=1e-3), rng=0)
    with torch.no_grad():
        for leaf in blank.params.values():
            leaf.zero_()
    with Checkpointer(root, async_save=False) as checkpointer:
        restored = checkpointer.restore('pre-schedule', blank)
    bitwise = all(torch.equal(restored.params[name], leaf)
                  for name, leaf in state.params.items())
    new = _lm('gpt2', inputs['gpt2_ckpt'], mesh=mesh, schedule=schedule)
    new.load_state_dict({name: leaf.detach() for name, leaf in
                         restored.params.items()})
    found['checkpoint'] = dict(
        bitwise=bitwise,
        old=tp_forward(old, mesh, inputs['tokens3'], policy,
                       grads=False)['logits'],
        new=tp_forward(new, mesh, inputs['tokens3'], policy,
                       grads=False)['logits'])
    out['tp_schedule'] = found


def tp_step(inputs, out):
    """Three steps of GPT-2 under TensorParallel (data=2 x model=2), under
    TensorParallel with FSDP and the schedule (fsdp=2 x model=2), and
    unplaced in this process: guarded, clipped AdamW steps' losses and
    health rows (the global grad norm, each piece counted once), and SGD
    steps' final parameters (Adam turns float32 noise in a gradient that
    is zero in exact arithmetic, the key bias's, into lr-sized steps)."""
    from tpusystem_torch.parallel import (MeshSpec, OverlapSchedule,
                                          batch_sharding)
    from tpusystem_torch.parallel.sharding import ShardingPolicy, gather_leaf
    from tpusystem_torch.train import (SGD, AdamW, Guard, NextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)
    tokens = torch.from_numpy(inputs['tokens']).long()
    schedule = OverlapSchedule(tp='overlap', fsdp='prefetch', chunks=2,
                               fsdp_min_size=64)
    found = {}
    for name, spec, knobs, fsdp in (
            ('unplaced', None, {}, False),
            ('tp', MeshSpec(data=2, model=2), {}, False),
            ('scheduled', MeshSpec(fsdp=2, model=2), {'schedule': schedule},
             True)):
        mesh = None if spec is None else spec.build()
        record = {}
        for kind in ('adamw', 'sgd'):
            module = _lm('gpt2', inputs['gpt2'], mesh=mesh, **knobs)
            optimizer = (AdamW(lr=1e-3, grad_clip=1.0) if kind == 'adamw'
                         else SGD(lr=0.1))
            guard = Guard() if kind == 'adamw' else None
            state = init_state(module, optimizer, rng=0)
            if guard is not None:
                state = guard.arm(state)
            rows = tokens
            if mesh is not None:
                state = ShardingPolicy(rules=module.partition_rules(),
                                       fsdp=fsdp, fsdp_min_size=64).place(
                    state, mesh)
                rows = batch_sharding(mesh)(tokens)
            step = build_train_step(module_apply(module), NextTokenLoss(),
                                    optimizer, guard=guard)
            losses, health = [], []
            for _ in range(3):
                state, (_, loss) = step(state, rows, rows)
                losses.append(float(loss))
                if guard is not None:
                    health.append(state.health.last.numpy().copy())
            record[kind] = losses
            if guard is not None:
                record['health'] = np.stack(health)
            else:
                with torch.no_grad():
                    record['params'] = {
                        key: _numpy(gather_leaf(leaf.to_local(), leaf, mesh)
                                    if mesh is not None else leaf)
                        for key, leaf in state.params.items()}
        found[name] = record
    out['tp_step'] = found


def tp_mlp(inputs, out):
    """The MLP's Adam steps under TensorParallel over every rank (model=-1)
    and over data=2 x fsdp=2 x model=2 (rules and FSDP combined)."""
    from tpusystem_torch.parallel import MeshSpec, batch_sharding
    from tpusystem_torch.parallel.mesh import PartitionSpec as P
    from tpusystem_torch.parallel.sharding import TensorParallel, local
    from tpusystem_torch.train import (Adam, CrossEntropyLoss,
                                       build_train_step, init_state,
                                       module_apply)
    images, labels = inputs['digits']
    # the port's Linear weight is the reference's kernel transposed
    for name, spec, policy in (
            ('tp', MeshSpec(model=-1), TensorParallel(rules=[
                (r'Dense_0/weight$', P('model', None)),
                (r'Dense_1/weight$', P(None, 'model'))])),
            ('combined', MeshSpec(data=2, fsdp=2, model=2), TensorParallel(
                rules=[(r'Dense_0/weight$', P('model', None))], fsdp=True,
                fsdp_min_size=64))):
        mesh = spec.build()
        module = _mlp(inputs['mlp'], (64,))
        optimizer = Adam(lr=1e-2)
        state = policy.place(init_state(module, optimizer, rng=0), mesh)
        step = build_train_step(module_apply(module), CrossEntropyLoss(),
                                optimizer)
        rows = batch_sharding(mesh)
        losses = []
        for _ in range(4):
            state, (_, loss) = step(state, rows(images),
                                    rows(labels.astype(np.int64)))
            losses.append(float(loss))
        out[f'{name}_losses'] = losses
        out[f'{name}_shards'] = {key: tuple(local(leaf).shape)
                                 for key, leaf in state.params.items()}


def _drain(engine, prompts, budget):
    for index, prompt in enumerate(prompts):
        engine.admit(prompt, budget, tag=f'r{index}')
    tokens: dict = {}
    for _ in range(64):
        for tag, new in engine.step().emitted.items():
            tokens.setdefault(tag, []).extend(int(t) for t in new)
        if not engine.active_rows:
            break
    return tokens


def serve_tp(inputs, out):
    """Engine(mesh=MeshSpec(model=2)) on gpt2_tiny and llama_tiny in
    float32 beside the one-rank engine, the ranks' tokens gathered; the
    engine's refusals and gates under the mesh."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import gpt2_tiny, llama_tiny
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.serve import Engine, pool_shardings
    from tpusystem_torch.train.decode_fused import fused_paged_reason
    found = {}
    for family, make in (('gpt2', gpt2_tiny), ('llama', llama_tiny)):
        module = make(dtype='float32', device='cpu')
        module.load_state_dict(params_from_jax(inputs[family]), strict=True)
        single = Engine(module, None, rows=2, block_size=8, device='cpu')
        sharded = Engine(module, None, rows=2, block_size=8, device='cpu',
                         mesh=MeshSpec(model=2))
        tokens = _drain(sharded, inputs['prompts'], 6)
        everyone = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(everyone, tokens)
        found[family] = dict(
            single=_drain(single, inputs['prompts'], 6), sharded=tokens,
            ranks=everyone, plan=tuple(sharded.tp_plan),
            decode_impl=sharded.decode_impl,
            kv={path: tuple(leaf.shape) for path, leaf in
                sharded._cache.items() if path.endswith('/key')},
            specs={path: tuple(placement.spec) for path, placement in
                   pool_shardings(single._cache, sharded.mesh).items()},
            audit=sharded.pool.audit())
    module = gpt2_tiny(dtype='float32', device='cpu')
    module.load_state_dict(params_from_jax(inputs['gpt2']), strict=True)
    refusals = {}
    try:
        Engine(module, None, rows=2, block_size=8, device='cpu',
               mesh=MeshSpec(data=2))
    except ValueError as error:
        refusals['data'] = str(error)
    try:
        Engine(module, None, rows=2, block_size=8, device='cpu',
               mesh=MeshSpec(model=2), draft_module=module, speculate=2)
    except ValueError as error:
        refusals['speculative'] = str(error)
    mesh = MeshSpec(model=2).build()
    refusals['fused'] = fused_paged_reason(module.replace(mesh=mesh))
    refusals['auto'] = Engine(module, None, rows=2, block_size=8,
                              device='cpu', mesh=mesh,
                              decode_impl='auto').decode_impl
    found['refusals'] = refusals
    out['serve_tp'] = found


def _pipelined(params, mesh, **config):
    """A ``GPT2Pipelined`` on the CPU in float32 with the reference's
    weights."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import GPT2Pipelined
    module = GPT2Pipelined(mesh=mesh, device='cpu', **config)
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def _rows_of(tensor, mesh):
    from tpusystem_torch.parallel import batch_sharding
    return batch_sharding(mesh)(torch.as_tensor(np.asarray(tensor)).long())


def pipe_forward(module, mesh, tokens, policy, grads=True):
    """``module`` as the placed step runs it (weights placed by ``policy``,
    each handed over as :meth:`keeps_split` asks, this rank's rows): its
    logits and, with ``grads``, the whole gradients of the global
    ``mean(logits^2)`` summed over the batch axes."""
    from torch.func import functional_call

    from tpusystem_torch.parallel.sharding import gather_leaf, local
    from tpusystem_torch.train.step import sync_grads
    weights = {name: leaf.detach().clone()
               for name, leaf in module.named_parameters()}
    placed = policy.place(weights, mesh)
    names = list(placed)
    leaves = [local(placed[name]).detach().requires_grad_()
              for name in names]
    given = {name: gather_leaf(leaf, placed[name], mesh,
                               module.keeps_split(name))
             for name, leaf in zip(names, leaves)}
    logits = functional_call(module, given, (_rows_of(tokens, mesh),))
    record = dict(logits=_numpy(logits))
    if grads:
        loss = logits.float().square().sum() / (
            np.prod(tokens.shape) * logits.shape[-1])
        found = torch.autograd.grad(loss, leaves)
        synced = sync_grads(list(found), [placed[n] for n in names], mesh)
        with torch.no_grad():
            record['grads'] = {name: _numpy(gather_leaf(grad, placed[name],
                                                        mesh))
                               for name, grad in zip(names, synced)}
    return record


def pipe_steps(module, mesh, tokens, targets, policy, optimizer, steps=1,
               path='gpipe', criterion=None):
    """``steps`` train steps of ``module`` placed by ``policy``: GPipe
    through ``build_train_step`` or 1F1B; the losses and the final
    parameters, gathered whole."""
    from tpusystem_torch.parallel.sharding import gather_leaf, local
    from tpusystem_torch.train import (NextTokenLoss, build_1f1b_train_step,
                                       build_train_step, init_state,
                                       module_apply)
    criterion = criterion or NextTokenLoss()
    state = policy.place(init_state(module, optimizer, rng=0), mesh)
    step = (build_train_step(module_apply(module), criterion, optimizer)
            if path == 'gpipe'
            else build_1f1b_train_step(module, criterion, optimizer))
    rows, wanted = _rows_of(tokens, mesh), _rows_of(targets, mesh)
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, rows, wanted)
        losses.append(float(loss))
    with torch.no_grad():
        params = {name: _numpy(gather_leaf(local(leaf), leaf, mesh))
                  for name, leaf in state.params.items()}
    return dict(losses=losses, params=params)


def _pp_stack_case(inputs, mesh, schedule, microbatches=2):
    """The plain tanh stack through ``pipeline_apply``: this rank's rows of
    the outputs and the whole gradient of ``sum(out^2)`` (over the batch
    axes)."""
    from tpusystem_torch.parallel import batch_sharding, pipeline_apply
    from tpusystem_torch.parallel.collectives import all_reduce_sum
    weights = torch.from_numpy(inputs['stack_weights']).requires_grad_()
    rows = batch_sharding(mesh)(inputs['stack_inputs'])
    out = pipeline_apply(lambda layer, x: torch.tanh(x @ layer['w']),
                         {'w': weights}, rows, mesh,
                         microbatches=microbatches, schedule=schedule)
    (grad,) = torch.autograd.grad(out.float().square().sum(), [weights])
    grad = all_reduce_sum(grad, mesh, ('data', 'fsdp'))
    return dict(out=_numpy(out), grad=_numpy(grad))


def pipeline(inputs, out):
    """The pipelines' twins (``tests/test_pipeline.py``,
    ``tests/test_schedule.py``'s pipelined tests) on eight ranks: GPT-2
    pipelined over data=2 x stage=4, stage=4 (ranks 0-3), data=2 (ranks
    0-1), data=2 x stage=2 x model=2, data=2 x fsdp=2 x stage=2 and fsdp=2 x
    model=2 x stage=2; the plain stack; the hop."""
    from tpusystem_torch.models import GPT2Pipelined
    from tpusystem_torch.parallel import (MeshSpec, OverlapSchedule,
                                          PipelineParallel, ShardingPolicy)
    from tpusystem_torch.parallel import collectives
    from tpusystem_torch.train import SGD, AdamW, NextTokenLoss, WithAuxLoss
    found = {}
    dp_stage = MeshSpec(data=2, stage=4).build()
    stage4 = MeshSpec(stage=4).build(ranks=[0, 1, 2, 3])
    data2 = MeshSpec(data=2).build(ranks=[0, 1])
    pp_tp = MeshSpec(data=2, stage=2, model=2).build()
    composed = MeshSpec(data=2, fsdp=2, stage=2).build()
    composed_tp = MeshSpec(fsdp=2, model=2, stage=2).build()
    small = dict(vocab_size=64, layers=4, dim=32, heads=4, max_seq=32,
                 dtype='float32', microbatches=2)
    wide = dict(vocab_size=256, layers=4, dim=64, heads=4, max_seq=64,
                dtype='float32', microbatches=8)
    narrow = dict(vocab_size=128, layers=4, dim=32, heads=2, max_seq=32,
                  dtype='float32')
    cases = inputs['pipeline']
    plain = PipelineParallel()

    # the hop: rank i's value to i + 1 forward, the cotangent back
    rank = dp_stage.axis_index('stage')
    value = torch.full((2,), float(rank), requires_grad=True)
    hopped = collectives.pp_hop(value, dp_stage, 'stage', 2)
    (back,) = torch.autograd.grad((hopped * (rank + 1)).sum(), [value])
    found['hop'] = dict(forward=_numpy(hopped), backward=_numpy(back))

    case = cases['forward']
    module = _pipelined(case['params'], dp_stage, **small)
    with torch.no_grad():
        found['forward'] = dict(
            pipelined=_numpy(module(_rows_of(case['tokens'], dp_stage))),
            sequential=_numpy(module.sequential_apply(
                torch.as_tensor(case['tokens']).long())))
    case = cases['grads']
    found['grads'] = pipe_forward(_pipelined(case['params'], dp_stage,
                                             **small),
                                  dp_stage, case['tokens'], plain)
    case = cases['train']
    found['train'] = pipe_steps(_pipelined(case['params'], dp_stage, **small),
                                dp_stage, case['tokens'], case['tokens'],
                                plain, AdamW(lr=1e-2), steps=4)
    found['stack'] = _pp_stack_case(inputs, dp_stage, None)
    for name, mesh, config in (
            ('1f1b', dp_stage, wide),
            ('interleaved_1f1b', dp_stage, dict(wide, layers=8, interleave=2)),
            ('partial_group', stage4, dict(narrow, layers=8, microbatches=6,
                                           interleave=2)),
            ('single_stage', data2, dict(narrow, layers=2, microbatches=2)),
            ('pp_tp_1f1b', pp_tp, dict(wide, microbatches=4))):
        if not mesh.member:
            continue
        case = cases[name]
        policy = (PipelineParallel(
            stacked_rules=GPT2Pipelined.block_partition_rules(),
            interleave=config.get('interleave', 1)))
        found[name] = {
            path: pipe_steps(_pipelined(case['params'], mesh, **config),
                                mesh, case['tokens'], case['tokens'],
                                policy, SGD(lr=0.1), path=path)
            for path in ('gpipe', '1f1b')}
    if stage4.member:
        case = cases['weighted']
        config = dict(narrow, microbatches=4)
        found['weighted'] = {
            path: pipe_steps(_pipelined(case['params'], stage4, **config),
                                stage4, np.abs(case['tokens']),
                                case['tokens'], plain, SGD(lr=0.1),
                                path=path)
            for path in ('gpipe', '1f1b')}
    for count in (8, 6):
        case = cases[f'interleaved_forward{count}']
        module = _pipelined(case['params'], dp_stage,
                            **dict(small, layers=8, microbatches=count,
                                   interleave=2))
        with torch.no_grad():
            found[f'interleaved_forward{count}'] = _numpy(
                module(_rows_of(case['tokens'], dp_stage)))
    case = cases['interleaved_grads']
    found['interleaved_grads'] = pipe_forward(
        _pipelined(case['params'], dp_stage,
                   **dict(small, layers=8, microbatches=8, interleave=2)),
        dp_stage, case['tokens'], PipelineParallel(interleave=2))
    case = cases['pp_tp_forward']
    module = _pipelined(case['params'], pp_tp, **small)
    found['pp_tp_forward'] = pipe_forward(
        module, pp_tp, case['tokens'],
        ShardingPolicy(rules=module.partition_rules()), grads=False)
    # pp='overlap': bit for bit the classic tick, and the fallback
    found['overlap'] = {
        chunks: _pp_stack_case(inputs, dp_stage, OverlapSchedule(
            pp='overlap', chunks=chunks)) if chunks else _pp_stack_case(
                inputs, dp_stage, None)
        for chunks in (0, 1, 2, 3)}
    # the composed pipelined MoE steps, without and with every arm
    schedule = OverlapSchedule(tp='overlap', fsdp='prefetch', pp='overlap',
                               moe='overlap', fsdp_min_size=64)
    moe = dict(vocab_size=256, layers=4, dim=48, heads=4, max_seq=64,
               dtype='float32', microbatches=2, moe_experts=2, moe_every=2,
               moe_capacity_factor=2.0)
    for name, mesh in (('composed', composed), ('composed_tp', composed_tp)):
        case = cases[name]
        policy = PipelineParallel(
            stacked_rules=GPT2Pipelined.block_partition_rules(), fsdp=True,
            fsdp_min_size=64)
        found[name] = {
            label: pipe_steps(_pipelined(case['params'], mesh,
                                         schedule=knob, **moe),
                              mesh, case['tokens'], case['tokens'], policy,
                              AdamW(lr=1e-3), steps=3,
                              criterion=WithAuxLoss(NextTokenLoss()))
            for label, knob in (('none', None), ('schedule', schedule))}
    out['pipeline'] = found


def _seq_rows(tensor, mesh):
    """This rank's rows over ``(data, fsdp)`` and positions over ``seq``."""
    from tpusystem_torch.parallel.mesh import PartitionSpec, Placement
    return Placement(mesh, PartitionSpec(('data', 'fsdp'), 'seq'))(
        torch.as_tensor(np.asarray(tensor)))


def _ring_case(mesh, q, k, v, **options):
    """``ring_self_attention`` on this rank's chunks: its output chunk and
    the chunks of the gradients of the global ``mean(out^2)``."""
    from tpusystem_torch.ops.ring import ring_self_attention
    leaves = [_seq_rows(t, mesh).float().requires_grad_() for t in (q, k, v)]
    got = ring_self_attention(*leaves, mesh, **options)
    loss = got.square().sum() / np.prod(q.shape)
    grads = torch.autograd.grad(loss, leaves)
    return dict(out=_numpy(got), grads=[_numpy(grad) for grad in grads])


def ring(inputs, out):
    """Sequence parallelism's twins (``tests/test_attention.py``'s ring
    tests) on eight ranks: ring, zigzag and ulysses over data=2 x seq=4,
    the non-causal ring over seq=8, the flops and the variant spies, GQA,
    the einsum inner kernel, and GPT-2 and Llama trained over data=2 x
    seq=4 beside the dense models."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import gpt2_tiny, llama_tiny
    from tpusystem_torch.ops import ring as ring_module
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.sharding import DataParallel
    from tpusystem_torch.train import (AdamW, NextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)
    mesh = MeshSpec(data=2, seq=4).build()
    seq8 = MeshSpec(seq=8).build()
    q, k, v = inputs['qkv']
    found = {variant: _ring_case(mesh, q, k, v, variant=variant)
             for variant in ('ring', 'ulysses')}
    single = inputs['single']
    found['noncausal'] = _ring_case(seq8, single, single, single,
                                    causal=False, variant='ring')
    found['einsum'] = _ring_case(mesh, q, k, v, variant='ring',
                                 inner='einsum')
    # the stripe blocks each rank attends, and which variant ran
    area, used = [], []
    real_attention, real_zigzag = (ring_module._attention_lse,
                                   ring_module.zigzag_ring_attention)
    real_permute = ring_module._ring_permute

    def counting(query, key, value, **options):
        area.append(query.shape[1] * key.shape[1])
        return real_attention(query, key, value, **options)

    def spying(*args, **options):
        used.append(1)
        return real_zigzag(*args, **options)

    rotated = []

    def spying_permute(mesh_, axis):
        permute = real_permute(mesh_, axis)

        def wrapped(tensor):
            rotated.append(tensor.shape[2])
            return permute(tensor)
        return wrapped

    ring_module._attention_lse = counting
    ring_module.zigzag_ring_attention = spying
    ring_module._ring_permute = spying_permute
    try:
        with torch.no_grad():
            for variant in ('zigzag', 'ring'):
                area.clear()
                ring_module.ring_self_attention(
                    *(_seq_rows(t, mesh).float() for t in (q, k, v)), mesh,
                    causal=True, variant=variant)
                found[f'area_{variant}'] = sum(area)
        found['upgraded'] = len(used)
        gq, gk, gv = inputs['gqa']
        for variant in ('ring', 'ulysses'):
            rotated.clear()
            found[f'gqa_{variant}'] = _ring_case(mesh, gq, gk, gv,
                                                 variant=variant)
            found[f'gqa_{variant}']['rotated'] = sorted(set(rotated))
    finally:
        ring_module._attention_lse = real_attention
        ring_module.zigzag_ring_attention = real_zigzag
        ring_module._ring_permute = real_permute
    # GPT-2 and Llama: three AdamW steps over data=2 x seq=4 beside the
    # dense models on the whole batch
    tokens = torch.as_tensor(inputs['tokens']).long()
    for family, make in (('gpt2', gpt2_tiny), ('llama', llama_tiny)):
        for variant in ('ring', 'ulysses', 'dense'):
            knobs = (dict(attention='xla') if variant == 'dense'
                     else dict(attention=variant, mesh=mesh))
            # the reference test's GPT-2 is bf16, its Llama float32
            module = make(dtype='bfloat16' if family == 'gpt2'
                          else 'float32', device='cpu', **knobs)
            module.load_state_dict(params_from_jax(inputs[family]),
                                   strict=True)
            optimizer = AdamW(lr=1e-3)
            state = init_state(module, optimizer, rng=0)
            rows = tokens
            if variant != 'dense':
                state = DataParallel().place(state, mesh)
                rows = _seq_rows(tokens, mesh)
            step = build_train_step(module_apply(module), NextTokenLoss(),
                                    optimizer)
            losses = []
            for _ in range(3):
                state, (_, loss) = step(state, rows, rows)
                losses.append(float(loss))
            found[f'{family}_{variant}'] = losses
    out['ring'] = found


def _moe_layer(mesh, params, hidden, grads=True, **config):
    """An ``MoEMLP`` over ``mesh`` with the reference's weights (whole on
    every rank) on this rank's rows of ``hidden``: its output rows, aux,
    seated count and, with ``grads``, the whole gradients of the global
    ``mean(out^2) + aux`` summed over the batch axes; ``None`` off the
    mesh."""
    from tpusystem_torch.ops.moe import MoEMLP
    from tpusystem_torch.parallel import batch_sharding
    from tpusystem_torch.parallel.collectives import all_reduce_sum
    if not mesh.member:
        return None
    layer = MoEMLP(hidden.shape[-1], device='cpu', mesh=mesh, **config)
    layer.load_state_dict({name: torch.from_numpy(np.asarray(value))
                           for name, value in params.items()})
    out, aux = layer(batch_sharding(mesh)(hidden))
    record = dict(out=_numpy(out), aux=float(aux),
                  seated=None if layer.seated is None else int(layer.seated))
    if grads:
        batch = ('data', 'fsdp')
        loss = (out.float().square().sum() / hidden.size
                + aux / mesh.axis_size(batch))
        names = [name for name, _ in layer.named_parameters()]
        found = torch.autograd.grad(loss, list(layer.parameters()))
        record['grads'] = {name: _numpy(all_reduce_sum(grad, mesh, batch))
                           for name, grad in zip(names, found)}
    return record


def _moe_model_step(params, mesh, tokens, **config):
    """One placed AdamW step of the MoE ``gpt2_tiny`` the overlap twins
    use: the global loss and the whole gradients, read through ``fault=``;
    ``None`` off the mesh."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import gpt2_tiny
    from tpusystem_torch.parallel.sharding import ShardingPolicy, gather_leaf
    from tpusystem_torch.train import (AdamW, NextTokenLoss, WithAuxLoss,
                                       build_train_step, init_state,
                                       module_apply)
    if not mesh.member:
        return None
    module = gpt2_tiny(dim=64, heads=4, mesh=mesh, moe_experts=2,
                       moe_every=2, moe_capacity_factor=2.0, dtype='float32',
                       device='cpu', **config)
    module.load_state_dict(params_from_jax(params), strict=True)
    optimizer = AdamW(lr=1e-3)
    state = ShardingPolicy(rules=module.partition_rules()).place(
        init_state(module, optimizer, rng=0), mesh)
    placed = dict(state.params)
    seen = {}

    def fault(step, grads, loss):
        seen['grads'] = {key: grad.detach().clone()
                         for key, grad in grads.items()}
        return grads, loss

    step = build_train_step(module_apply(module),
                            WithAuxLoss(NextTokenLoss()), optimizer,
                            fault=fault)
    rows = _rows_of(tokens, mesh)
    state, (_, loss) = step(state, rows, rows)
    with torch.no_grad():
        grads = {key: _numpy(gather_leaf(grad, placed[key], mesh))
                 for key, grad in seen['grads'].items()}
    return dict(loss=float(loss), grads=grads)


def expert(inputs, out):
    """The expert-parallel twins (``tests/test_moe.py``, the ``moe=`` arm
    of ``tests/test_schedule.py``) on eight ranks: GPT-2 over data=2 x
    expert=4; the layer over data=2 x expert=2 (ranks 0-3) on every
    exchange, and over expert=2 (ranks 0-1) under drops and skew; the
    guards over data=2 x expert=2 x model=2; the MoE gpt2_tiny under
    ``moe='overlap'`` and one-shot."""
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.ops.moe import MoEMLP
    from tpusystem_torch.parallel import (MeshSpec, OverlapSchedule,
                                          ShardingPolicy)
    from tpusystem_torch.parallel.sharding import local, shard_axes
    from tpusystem_torch.train import (AdamW, NextTokenLoss, WithAuxLoss,
                                       build_train_step, init_state,
                                       module_apply)
    cases, found = inputs['expert'], {}
    wide = MeshSpec(data=2, expert=4).build()
    pair = MeshSpec(data=2, expert=2).build(ranks=[0, 1, 2, 3])
    duo = MeshSpec(expert=2).build(ranks=[0, 1])
    guarded = MeshSpec(data=2, expert=2, model=2).build()

    module = GPT2(vocab_size=64, layers=2, dim=32, heads=4, max_seq=32,
                  dropout=0.0, dtype='float32', moe_experts=4, moe_every=2,
                  moe_k=2, mesh=wide, device='cpu')
    module.load_state_dict(params_from_jax(cases['train']['params']),
                           strict=True)
    optimizer = AdamW(lr=1e-2)
    state = ShardingPolicy(rules=GPT2.partition_rules()).place(
        init_state(module, optimizer, rng=0), wide)
    step = build_train_step(module_apply(module),
                            WithAuxLoss(NextTokenLoss()), optimizer)
    rows = _rows_of(cases['train']['tokens'], wide)
    losses = []
    for _ in range(4):
        state, ((logits, aux), loss) = step(state, rows, rows)
        losses.append(float(loss))
    w1 = state.params['h_1.moe.w1']
    found['train'] = dict(losses=losses, logits=tuple(logits.shape),
                          axes=shard_axes(w1), piece=tuple(local(w1).shape),
                          aux=float(aux))

    layer = cases['layer']
    for name, config in (
            ('dense', dict(dispatch='dense')),
            ('quota', dict(dispatch='sparse')),
            ('ragged', dict(dispatch='sparse', exchange='ragged')),
            ('emulated', dict(dispatch='sparse',
                              exchange='ragged-emulated'))):
        found[name] = _moe_layer(pair, layer['params'], layer['hidden'],
                                 experts=4, k=2, capacity_factor=4.0,
                                 dtype='float32', **config)
    drops = cases['drops']
    for name in ('ragged', 'ragged-emulated'):
        found[f'drops_{name}'] = _moe_layer(
            duo, drops['params'], drops['hidden'], grads=False, experts=4,
            k=2, capacity_factor=0.75, dtype='float32', dispatch='sparse',
            exchange=name)
    skew = cases['skew']
    for name, config in (('dense', dict(dispatch='dense')),
                         ('quota', dict(dispatch='sparse')),
                         ('ragged', dict(dispatch='sparse',
                                         exchange='ragged'))):
        found[f'skew_{name}'] = _moe_layer(
            duo, skew['params'], skew['hidden'], grads=False, experts=2,
            k=1, capacity_factor=1.0, dtype='float32', **config)

    guards = cases['guards']
    refusals = {}
    hidden = torch.from_numpy(guards['hidden'])
    rows = hidden[guarded.axis_index('data') * 4:][:4]
    for name, config, mesh in (
            ('dense_only', dict(dispatch='sparse'), guarded),
            ('fused', dict(dispatch='sparse', sparse_impl='fused'), pair),
            ('exchange', dict(dispatch='sparse', exchange='magic'), pair)):
        if not mesh.member:
            continue
        layer_ = MoEMLP(32, 4, dtype='float32', mesh=mesh, device='cpu',
                        **config)
        try:
            layer_(rows)
        except ValueError as error:
            refusals[name] = str(error)
    try:
        MoEMLP(32, 4, dtype='float32', mesh=guarded, dispatch='auto',
               sparse_impl='fussed', device='cpu')
    except ValueError as error:
        refusals['typo'] = str(error)
    found['refusals'] = refusals
    found['auto'] = _moe_layer(guarded, guards['params'], guards['hidden'],
                               grads=False, experts=4, dtype='float32',
                               dispatch='auto')

    sched = cases['schedule']
    overlap = OverlapSchedule(moe='overlap')
    for name, tokens, config in (
            ('one_shot', sched['tokens'], {}),
            ('overlap', sched['tokens'], dict(schedule=overlap)),
            ('ragged_one_shot', sched['tokens1'],
             dict(moe_exchange='ragged-emulated')),
            ('ragged_overlap', sched['tokens1'],
             dict(schedule=overlap, moe_exchange='ragged-emulated'))):
        found[f'model_{name}'] = _moe_model_step(sched['params'], pair,
                                                 tokens, **config)
    for name, schedule in (('layer_one_shot', None),
                           ('layer_overlap', overlap)):
        found[name] = _moe_layer(pair, sched['layer_params'],
                                 sched['layer_hidden'], experts=2, k=2,
                                 capacity_factor=2.0, dtype='float32',
                                 dispatch='sparse', schedule=schedule)
    out['expert'] = found


def _table_lookup(mesh, table, ids, weights=None, cot=None, piece=False):
    """A ``ShardedEmbedding(64, 8)`` over ``mesh`` with ``table`` on this
    rank's rows of ``ids``: whole on every rank (the lookup cuts it), or
    with ``piece`` this rank's rows of it (as the placed step hands a
    table over); the output rows and, with ``cot``, the whole gradient of
    ``sum(out * cot)`` summed over the batch axes."""
    from tpusystem_torch.parallel import batch_sharding
    from tpusystem_torch.parallel.collectives import all_reduce_sum
    from tpusystem_torch.parallel.sharding import (TABLE_AXES, TensorParallel,
                                                   gather_leaf, local,
                                                   table_row_spec)
    from tpusystem_torch.recsys import ShardedEmbedding
    module = ShardedEmbedding(64, 8, mesh=mesh, device='cpu')
    whole = torch.from_numpy(table)
    given = leaf = whole.clone().requires_grad_()
    if piece:
        placed = TensorParallel([(r'embedding$', table_row_spec(2))]).place(
            {'embedding': whole}, mesh)['embedding']
        leaf = local(placed).detach().requires_grad_()
        given = gather_leaf(leaf, placed, mesh, keep=TABLE_AXES)
    rows = batch_sharding(mesh)
    found = torch.func.functional_call(
        module, {'embedding': given},
        (rows(ids), None if weights is None else rows(weights)))
    record = dict(out=_numpy(found))
    if cot is not None:
        (grad,) = torch.autograd.grad((found * rows(cot)).sum(), [leaf])
        grad = all_reduce_sum(grad, mesh, ('data', 'fsdp'))
        if piece:
            with torch.no_grad():
                grad = gather_leaf(grad, placed, mesh)
        record['grad'] = _numpy(grad)
    return record


def _recsys_steps(module, policy, mesh, batch, targets, optimizer,
                  criterion, steps=3):
    """``steps`` placed steps; the losses and the final parameters
    gathered whole."""
    from tpusystem_torch.parallel import batch_sharding
    from tpusystem_torch.parallel.sharding import gather_leaf, local
    from tpusystem_torch.train import build_train_step, init_state, \
        module_apply
    state = policy.place(init_state(module, optimizer, rng=0), mesh)
    step = build_train_step(module_apply(module), criterion, optimizer)
    rows = batch_sharding(mesh)
    inputs = {key: rows(value) for key, value in batch.items()}
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, inputs, rows(targets))
        losses.append(float(loss))
    with torch.no_grad():
        params = {name: _numpy(gather_leaf(local(leaf), leaf, mesh))
                  for name, leaf in state.params.items()}
    return dict(losses=losses, params=params), state


def tables(inputs, out):
    """The table-parallel twins (``tests/test_recsys.py``) over data=2 x
    model=2 x expert=2: the routed lookup forward and gradient from a whole
    table and from this rank's rows, the DLRM drill (row-split tables
    against replicated ones, with a table the axes do not divide), a
    two-tower model, and a checkpoint and a memstore round trip of
    row-split tables."""
    from tpusystem_torch.checkpoint import (Checkpointer, HotState,
                                            deserialize_state, merge_hot,
                                            serialize_state)
    from tpusystem_torch.checkpoint.memstore import ShardedLeaf
    from tpusystem_torch.convert import params_from_jax
    from tpusystem_torch.models import dlrm_tiny, two_tower_tiny
    from tpusystem_torch.parallel import MeshSpec
    from tpusystem_torch.parallel.sharding import (DataParallel,
                                                   TensorParallel, local,
                                                   shard_axes, whole_leaf)
    from tpusystem_torch.recsys import ShardedEmbedding
    from tpusystem_torch.registry import gethash
    from tpusystem_torch.train import (SGD, AdamW, BCEWithLogitsLoss,
                                       CrossEntropyLoss)
    cases, found = inputs['tables'], {}
    mesh = MeshSpec(data=2, model=2, expert=2).build()
    plain, split = (ShardedEmbedding(64, 8, mesh=mesh_, device='cpu')
                    for mesh_ in (None, mesh))
    found['init'] = dict(equal=torch.equal(plain.embedding, split.embedding),
                         digest=gethash(plain) == gethash(split))
    forward, grads = cases['forward'], cases['grads']
    for piece in (False, True):
        name = 'piece' if piece else 'whole'
        found[f'forward_{name}'] = _table_lookup(
            mesh, forward['table'], forward['ids'], forward['weights'],
            piece=piece)
        found[f'grads_{name}'] = _table_lookup(
            mesh, grads['table'], grads['ids'], cot=grads['cot'],
            piece=piece)

    batch = {key: value for key, value in cases['batch'].items()}
    labels = cases['labels']
    for name, vocabs in (('drill', (64, 32)), ('odd', (64, 33))):
        record = {}
        for kind in ('split', 'replicated'):
            module = dlrm_tiny(vocabs=vocabs, device='cpu',
                               mesh=mesh if kind == 'split' else None)
            if name == 'drill':
                module.load_state_dict(params_from_jax(cases['dlrm']),
                                       strict=True)
            policy = (TensorParallel(module.partition_rules())
                      if kind == 'split' else DataParallel())
            record[kind], state = _recsys_steps(
                module, policy, mesh, batch, labels, AdamW(lr=1e-2),
                BCEWithLogitsLoss())
            if kind == 'split':
                record['axes'] = {key: shard_axes(leaf)
                                  for key, leaf in state.params.items()
                                  if 'table' in key}
        found[name] = record

    towers = cases['towers']
    record = {}
    for kind in ('split', 'replicated'):
        module = two_tower_tiny(device='cpu',
                                mesh=mesh if kind == 'split' else None)
        policy = (TensorParallel(module.partition_rules())
                  if kind == 'split' else DataParallel())
        record[kind], _ = _recsys_steps(
            module, policy, mesh, towers['batch'], towers['targets'],
            SGD(lr=0.1), CrossEntropyLoss())
    found['towers'] = record

    module = dlrm_tiny(mesh=mesh, device='cpu')
    policy = TensorParallel(module.partition_rules())
    _, state = _recsys_steps(module, policy, mesh, batch, labels,
                             AdamW(lr=1e-2), BCEWithLogitsLoss(), steps=1)
    root = inputs['root'] + '/tables'
    with Checkpointer(root, async_save=False) as checkpointer:
        checkpointer.save('recsys', 1, state)
    torch.distributed.barrier()
    from tpusystem_torch.train import init_state
    blank = policy.place(init_state(dlrm_tiny(mesh=mesh, device='cpu'),
                                    AdamW(lr=1e-2), rng=0), mesh)
    with Checkpointer(root, async_save=False) as checkpointer:
        restored = checkpointer.restore('recsys', blank, epoch=1)
    pieces = lambda tree: {key: local(leaf) for key, leaf in tree.items()}
    found['checkpoint'] = all(
        torch.equal(local(restored.params[key]), value)
        for key, value in pieces(state.params).items())
    blank = policy.place(init_state(dlrm_tiny(mesh=mesh, device='cpu'),
                                    AdamW(lr=1e-2), rng=0), mesh)
    # every rank's blob carries its pieces: merged, as a restore merges them
    blobs = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(blobs, serialize_state(state))
    merged_blob = merge_hot([HotState(step=1, digest='', blob=blob)
                             for blob in blobs]).blob
    again = deserialize_state(merged_blob, blank)
    table = state.params['table_0.embedding']
    mine = ShardedLeaf.from_tensor(table)
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, mine)
    merged = everyone[0]
    for other in everyone[1:]:
        merged = merged.merged(other)
    found['memstore'] = dict(
        equal=all(torch.equal(local(again.params[key]), value)
                  for key, value in pieces(state.params).items()),
        reassembled=torch.equal(merged.reassemble(), whole_leaf(table)),
        pieces=len(merged.shards))
    out['tables'] = found


def oracle_train_step(apply_fn, criterion, optimizer, accumulate=1):
    """The placed train step as it ran before per-unit gathering, written
    out: every leaf gathered whole before each microbatch's forward
    (``gather_leaf``), held until its backward ends, the forward, the
    gradients (``torch.autograd.grad``), ``sync_grads`` and the update."""
    from tpusystem_torch.ops.threefry import split
    from tpusystem_torch.parallel.collectives import all_reduce_sum
    from tpusystem_torch.parallel.sharding import (gather_leaf, local,
                                                   local_tree)
    from tpusystem_torch.train.step import (batch_axes, chunk_outputs,
                                            chunk_targets, sync_grads)
    weight_fn = getattr(criterion, 'weight', None)
    keeps = apply_fn.keeps_split

    def step(state, inputs, targets):
        mesh = state.mesh
        rng = state.next_rng()
        names = list(state.params)
        placed = [state.params[name] for name in names]
        held = [local(leaf) for leaf in placed]
        micro = (list(zip(inputs.split(inputs.shape[0] // accumulate),
                          targets.split(targets.shape[0] // accumulate),
                          split(rng, accumulate)))
                 if accumulate > 1 else [(inputs, targets, rng)])
        axes = batch_axes(mesh)
        micro = [(inputs_, chunk_targets(targets_, mesh), rng_)
                 for inputs_, targets_, rng_ in micro]
        weights = [weight_fn(micro_targets).float() if weight_fn
                   else torch.ones(()) for _, micro_targets, _ in micro]
        total = torch.clamp(all_reduce_sum(torch.stack(weights).sum(), mesh,
                                           axes), min=1e-8)
        grads, loss = None, torch.zeros(())
        for (micro_inputs, micro_targets, micro_rng), weight in zip(
                micro, weights):
            leaves = [piece.detach().requires_grad_(piece.is_floating_point())
                      for piece in held]
            params = {name: gather_leaf(leaf, whole, mesh, keeps(name))
                      for name, leaf, whole in zip(names, leaves, placed)}
            outputs = apply_fn(params, micro_inputs, micro_rng, True)
            share = criterion(chunk_outputs(outputs, mesh),
                              micro_targets) * (weight / total)
            found = torch.autograd.grad(share, leaves)
            grads = (list(found) if grads is None
                     else [sum_ + grad for sum_, grad in zip(grads, found)])
            loss = loss + share.detach()
        grads = sync_grads(grads, placed, mesh)
        loss = all_reduce_sum(loss, mesh, axes)
        optimizer.step(dict(zip(names, held)), dict(zip(names, grads)),
                       local_tree(state.opt_state))
        state.step += 1
        return state, (None, loss)

    return step


def oracle_eval_step(apply_fn, criterion):
    """The placed eval step before per-unit gathering: every leaf gathered
    whole, the forward, the global loss."""
    from tpusystem_torch.parallel.collectives import all_reduce_sum
    from tpusystem_torch.parallel.sharding import gather_leaf, local
    from tpusystem_torch.train.step import batch_axes

    @torch.no_grad()
    def step(state, inputs, targets):
        mesh = state.mesh
        params = {name: gather_leaf(local(leaf), leaf, mesh)
                  for name, leaf in state.params.items()}
        outputs = apply_fn(params, inputs, None, False)
        weight = criterion.weight(targets).float()
        axes = batch_axes(mesh)
        total = torch.clamp(all_reduce_sum(weight, mesh, axes), min=1e-8)
        share = criterion(outputs, targets) * (weight / total)
        return outputs, all_reduce_sum(share, mesh, axes)

    return step


def oracle_1f1b_step(model, criterion, optimizer):
    """The 1F1B step before per-unit gathering: every leaf gathered whole
    (over the axes ``keeps_split`` leaves out) before the schedule."""
    from tpusystem_torch.parallel.pipeline import pipeline_train
    from tpusystem_torch.parallel.sharding import (gather_leaf, local,
                                                   local_tree)
    from tpusystem_torch.train.step import _own_piece

    train = pipeline_train(
        model._embed, model._block_fn(),
        lambda reps, acts, tgt: criterion(model._head(reps, acts), tgt),
        model.mesh, microbatches=model.microbatches,
        weight_fn=getattr(criterion, 'weight', None))

    def step(state, inputs, targets):
        names = list(state.params)
        held = [local(state.params[name]) for name in names]
        with torch.no_grad():
            given = {name: gather_leaf(piece, state.params[name],
                                       state.mesh, model.keeps_split(name))
                     for name, piece in zip(names, held)}
        replicated = {name: leaf for name, leaf in given.items()
                      if not name.startswith('h.')}
        stacked = {name[2:]: leaf for name, leaf in given.items()
                   if name.startswith('h.')}
        loss, (d_replicated, d_stacked) = train(replicated, stacked, inputs,
                                                targets)
        grads = dict(d_replicated, **{'h.' + name: grad
                                      for name, grad in d_stacked.items()})
        grads = {name: _own_piece(grads[name], state.params[name],
                                  state.mesh, model.keeps_split(name))
                 for name in names}
        optimizer.step(dict(zip(names, held)), grads,
                       local_tree(state.opt_state))
        state.step += 1
        return state, (None, loss)

    return step


FSDP_TINY = dict(vocab_size=256, layers=4, dim=64, heads=4, max_seq=128,
                 dropout=0.0, attention='flash')


def _unit_bytes(placed: dict, units: list, mesh, keep) -> list:
    """Each unit's bytes of whole gathered leaves on this rank: a leaf's
    piece times the ranks of the axes it is gathered over, a stacked
    leaf's per layer slice (``layers``), leaves gathered over no axis of
    more than one rank left out."""
    from tpusystem_torch.parallel.sharding import local, shard_axes
    found = []
    for names, per in units:
        total = 0
        for name in names:
            leaf = placed[name]
            factor = 1
            for axes in shard_axes(leaf).values():
                for axis in axes:
                    if axis not in keep(name):
                        factor *= mesh.shape[axis]
            if factor > 1:
                total += local(leaf).nbytes * factor // per
        found.append(total)
    return found


# each family's units of per-unit gathering: the embeddings, the prefix of
# a block's leaves (``{}`` its index) and of the scanned stack's, the final
# norm with the head
FAMILY_UNITS = {
    'gpt2': (['wte.embedding', 'wpe.embedding'], 'h_{}.', 'hs.',
             ['ln_f.scale', 'ln_f.bias', 'wte.embedding']),
    'llama': (['embed.embedding'], 'layer_{}.', 'blocks.',
              ['final_norm.scale', 'lm_head.kernel']),
    'pipelined': (['wte.embedding', 'wpe.embedding'], None, 'h.',
                  ['ln_f.scale', 'ln_f.bias', 'wte.embedding'])}


def _family_units(names: list, layers: int, scanned: bool,
                  family: str) -> list:
    """``(leaf names, slices)`` of a model's units: the embeddings, each
    block (each layer slice of the stack: ``slices`` = layers), the final
    norm with the head (GPT-2's the tied table)."""
    embed, block, stack, head = FAMILY_UNITS[family]
    if scanned:
        blocks = [([name for name in names if name.startswith(stack)],
                   layers)]
    else:
        blocks = [([name for name in names
                    if name.startswith(block.format(index))], 1)
                  for index in range(layers)]
    return [(embed, 1)] + blocks + [(head, 1)]


def _fsdp_run(kind, path, inputs, mesh, policy, knobs, accumulate, steps):
    """``steps`` steps of ``kind`` (``'train'``, ``'eval'`` or ``'1f1b'``)
    on ``path`` (``'units'``, the port's step, or ``'oracle'``): losses,
    final parameters gathered whole, and the high-water mark of whole
    gathered bytes over the steps."""
    from tpusystem_torch.models import GPT2, GPT2Pipelined, llama_tiny
    from tpusystem_torch.parallel import batch_sharding
    from tpusystem_torch.parallel.sharding import whole_bytes, whole_leaf
    from tpusystem_torch.train import (AdamW, NextTokenLoss, WithAuxLoss,
                                       build_1f1b_train_step,
                                       build_eval_step, build_train_step,
                                       init_state, module_apply)
    tokens = torch.from_numpy(inputs['fsdp_tokens']).long()
    knobs = dict(knobs)
    family = knobs.pop('family', 'gpt2')
    criterion = (WithAuxLoss(NextTokenLoss()) if knobs.get('moe_experts')
                 else NextTokenLoss())
    optimizer = AdamW(lr=1e-2, grad_clip=1.0)
    config = dict(FSDP_TINY, **knobs)
    if kind == '1f1b':
        del config['dropout'], config['attention']
        module = GPT2Pipelined(device='cpu', microbatches=2, **config)
    elif family == 'llama':
        module = llama_tiny(device='cpu', layers=FSDP_TINY['layers'],
                            **knobs)
    else:
        module = GPT2(device='cpu', **config)
    module.init_weights(torch.Generator().manual_seed(inputs['fsdp_seed']))
    state = policy.place(init_state(module, optimizer, rng=0), mesh)
    if kind == '1f1b':
        step = (build_1f1b_train_step(module, criterion, optimizer)
                if path == 'units'
                else oracle_1f1b_step(module, criterion, optimizer))
    elif kind == 'train':
        apply_fn = module_apply(module)
        step = (build_train_step(apply_fn, criterion, optimizer,
                                 accumulate=accumulate)
                if path == 'units'
                else oracle_train_step(apply_fn, criterion, optimizer,
                                       accumulate))
    else:
        apply_fn = module_apply(module)
        evaluate = (build_eval_step(apply_fn, criterion) if path == 'units'
                    else oracle_eval_step(apply_fn, criterion))

        def step(state, rows, targets):
            return state, evaluate(state, rows, targets)
    rows = batch_sharding(mesh)(tokens)
    losses, peak = [], 0
    for _ in range(steps):
        whole_bytes.reset()
        before = whole_bytes.live
        state, (_, loss) = step(state, rows, rows)
        peak = max(peak, whole_bytes.peak - before)
        losses.append(float(loss))
    return dict(losses=losses, peak=peak, state=state, module=module,
                params={name: _numpy(whole_leaf(leaf))
                        for name, leaf in state.params.items()})


def _fsdp_unplaced(inputs, steps=2) -> list:
    """The losses of the train steps ``fsdp_units`` runs, unplaced in this
    process."""
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.train import (AdamW, NextTokenLoss,
                                       build_train_step, init_state,
                                       module_apply)
    module = GPT2(device='cpu', **FSDP_TINY)
    module.init_weights(torch.Generator().manual_seed(inputs['fsdp_seed']))
    optimizer = AdamW(lr=1e-2, grad_clip=1.0)
    state = init_state(module, optimizer, rng=0)
    step = build_train_step(module_apply(module), NextTokenLoss(), optimizer)
    tokens = torch.from_numpy(inputs['fsdp_tokens']).long()
    losses = []
    for _ in range(steps):
        state, (_, loss) = step(state, tokens, tokens)
        losses.append(float(loss))
    return losses


def fsdp_units(inputs, out):
    """Per-unit FSDP gathering against the whole-gather oracle: each case's
    losses and parameters from the port's step and from the oracle, and
    both runs' high-water marks of whole gathered bytes beside the bound
    (the largest unit's whole bytes and a bf16 cast of them)."""
    from tpusystem_torch.parallel import (FullyShardedDataParallel, MeshSpec,
                                          PipelineParallel)
    from tpusystem_torch.parallel.sharding import TensorParallel
    from tpusystem_torch.models import GPT2
    found = {}
    ranks = torch.distributed.get_world_size()
    fsdp = FullyShardedDataParallel(min_size=64)
    cases = [('fsdp', 'train', MeshSpec(fsdp=-1), fsdp, {}, 1),
             ('fsdp_accumulate', 'train', MeshSpec(fsdp=-1), fsdp, {}, 2),
             ('fsdp_scan', 'train', MeshSpec(fsdp=-1), fsdp,
              {'scan_layers': True}, 1),
             ('fsdp_remat', 'train', MeshSpec(fsdp=-1), fsdp,
              {'remat': True}, 1),
             ('fsdp_eval', 'eval', MeshSpec(fsdp=-1), fsdp, {}, 1)]
    if ranks == 2:
        cases += [
            ('llama', 'train', MeshSpec(fsdp=-1), fsdp,
             {'family': 'llama'}, 2),
            ('llama_scan', 'train', MeshSpec(fsdp=-1), fsdp,
             {'family': 'llama', 'scan_layers': True}, 1),
            ('moe', 'train', MeshSpec(fsdp=-1), fsdp, {'moe_experts': 4},
             1),
            ('1f1b_one_stage', '1f1b', MeshSpec(stage=1, fsdp=2),
             PipelineParallel(fsdp=True, fsdp_min_size=64), {'mesh': True},
             1)]
    if ranks == 4:
        cases += [
            ('data_fsdp', 'train', MeshSpec(data=2, fsdp=2), fsdp, {}, 2),
            ('data_fsdp_scan', 'train', MeshSpec(data=2, fsdp=2), fsdp,
             {'scan_layers': True, 'remat': True}, 2),
            ('tp_fsdp', 'train', MeshSpec(model=2, fsdp=2),
             TensorParallel(GPT2.partition_rules(), fsdp=True,
                            fsdp_min_size=64), {'mesh': True}, 1),
            ('1f1b', '1f1b', MeshSpec(stage=2, fsdp=2),
             PipelineParallel(fsdp=True, fsdp_min_size=64), {'mesh': True},
             1)]
    for name, kind, spec, policy, knobs, accumulate in cases:
        mesh = spec.build()
        if knobs.get('mesh'):
            knobs = dict(knobs, mesh=mesh)
        runs = {path: _fsdp_run(kind, path, inputs, mesh, policy, knobs,
                                accumulate, steps=2)
                for path in ('units', 'oracle')}
        module, placed = runs['units']['module'], runs['units']['state'].params
        keep = getattr(module, 'keeps_split', lambda name: ())
        # a stage's loop of many stages gathers a chunk of the stack or the
        # replicated leaves a unit (its gathers alone counted); the train
        # and eval steps and the loop of one stage gather each model unit
        # and count each gathered leaf's casts too (one bf16 cast beside it)
        chunked = kind == '1f1b' and mesh.shape['stage'] > 1
        if chunked:
            units = [([name for name in placed if not name.startswith('h.')],
                      1), ([name for name in placed if name.startswith('h.')],
                           1)]
        else:
            family = ('pipelined' if kind == '1f1b'
                      else knobs.get('family', 'gpt2'))
            units = _family_units(list(placed), FSDP_TINY['layers'],
                                  kind == '1f1b'
                                  or knobs.get('scan_layers', False), family)
        sizes = _unit_bytes(placed, units, mesh,
                            keep if kind != 'eval' else lambda name: ())
        found[name] = dict(
            losses={path: runs[path]['losses'] for path in runs},
            params={path: runs[path]['params'] for path in runs},
            peak={path: runs[path]['peak'] for path in runs},
            units=sizes,
            bound=max(sizes) if chunked else max(sizes) * 3 // 2)
        if name == 'fsdp':
            found[name]['unplaced'] = _fsdp_unplaced(inputs)
    found['guard'] = _stand_in_guard(MeshSpec(fsdp=-1).build(), fsdp)
    out['fsdp_units'] = found


def _stand_in_guard(mesh, policy) -> dict:
    """What a stand-in of a split leaf allows: its metadata, and its whole
    leaf through ``gathered``, equal to ``gather_leaf``'s; an operation on
    the stand-in itself raises under ``unit_gathering`` and
    ``guard_stand_ins`` (else it would compute on the stand-in's NaN)."""
    from tpusystem_torch.models import GPT2
    from tpusystem_torch.parallel.sharding import (defer_leaf, gather_leaf,
                                                   gathered, guard_stand_ins,
                                                   is_deferred, local,
                                                   unit_gathering)
    from tpusystem_torch.train import AdamW, init_state
    module = GPT2(device='cpu', **FSDP_TINY)
    state = policy.place(init_state(module, AdamW(lr=1e-2), rng=0), mesh)
    leaf = state.params['wte.embedding']
    stand_in = defer_leaf(local(leaf), leaf, mesh)
    found = dict(deferred=is_deferred(stand_in),
                 shape=list(stand_in.shape),
                 whole_shape=list(module.wte.embedding.shape))
    for name, context in (('unit_gathering', unit_gathering),
                          ('guard_stand_ins', guard_stand_ins)):
        with context():
            meta = (stand_in.shape, stand_in.dtype, stand_in.device,
                    stand_in.dim(), stand_in.is_floating_point())
            whole = gathered(stand_in)
            raised = []
            for use in (lambda: stand_in * 2, lambda: stand_in.to(
                    torch.bfloat16), lambda: stand_in.T,
                    lambda: torch.cat([stand_in, whole])):
                try:
                    use()
                except RuntimeError as error:
                    raised.append('stand-in' in str(error))
                else:
                    raised.append(False)
        found[name] = dict(
            meta=len(meta), raised=raised,
            whole_equal=bool(torch.equal(
                whole, gather_leaf(local(leaf), leaf, mesh))))
    return found


SCENARIOS = {'layouts': lambda inputs, out: mesh_layouts(out),
             'mlp': train_mlp,
             'collectives': lambda inputs, out: collectives(out),
             'loader': loader_rows, 'lm': masked_lm, 'parity': parity,
             'checkpoint': checkpoints, 'resnet': resnet,
             'guarded': guarded,
             'resharding': resharding, 'wave': wave_drill,
             'double_loss': double_loss, 'overlap': overlap_rings,
             'schedule': schedule_rings, 'tp_impl': tp_impl,
             'tp_schedule': tp_schedule, 'tp_step': tp_step,
             'tp_mlp': tp_mlp, 'serve_tp': serve_tp,
             'pipeline': pipeline, 'ring': ring, 'expert': expert,
             'tables': tables, 'fsdp_units': fsdp_units}


def launch(root, inputs: dict, ranks: int = 4, timeout: float = 240) -> list:
    """Run ``inputs['scenarios']`` in a world of ``ranks`` processes of this
    program (a coordinator on a free port, ``OMP_NUM_THREADS=1``, no
    ``TPUSYSTEM_*`` variables), each rank killed if it hangs; returns every
    rank's results, in rank order. ``root`` is a directory for the files."""
    import os
    import pathlib
    import socket
    import subprocess
    root = pathlib.Path(root)
    with open(root / 'inputs.pkl', 'wb') as handle:
        pickle.dump(inputs, handle)
    with socket.socket() as probe:
        probe.bind(('127.0.0.1', 0))
        coordinator = f'127.0.0.1:{probe.getsockname()[1]}'
    env = {key: value for key, value in os.environ.items()
           if not key.startswith('TPUSYSTEM_')}
    env.update(PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1]),
               OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(ranks), coordinator,
         str(root / 'inputs.pkl'), str(root / f'out{rank}.pkl')],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(ranks)]
    try:
        outputs = [proc.communicate(timeout=timeout)[0].decode()
                   for proc in procs]
    finally:
        for proc in procs:      # a hung rank must not outlive the caller
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, (
            f'rank {rank} failed:\n{outputs[rank][-4000:]}')
    results = []
    for rank in range(ranks):
        with open(root / f'out{rank}.pkl', 'rb') as handle:
            results.append(pickle.load(handle))
    return results


def main() -> None:
    rank, nprocs = int(sys.argv[1]), int(sys.argv[2])
    coordinator, inputs_path, out_path = sys.argv[3:6]
    torch.set_num_threads(1)
    from tpusystem_torch.parallel import multihost
    with redirect_stderr(io.StringIO()):      # the store's hostname notes
        multihost.initialize(coordinator, nprocs, rank, device='cpu')
    with open(inputs_path, 'rb') as handle:
        inputs = pickle.load(handle)
    inputs['root'] = tempfile.mkdtemp() if inputs.get('root') is None \
        else inputs['root']
    out: dict = {'rank': rank}
    for name in inputs['scenarios']:
        SCENARIOS[name](inputs, out)
        torch.distributed.barrier()
    with open(out_path, 'wb') as handle:
        pickle.dump(out, handle)
    multihost.shutdown()


if __name__ == '__main__':
    main()
