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
    # a mesh with a model axis builds; placing a leaf split over it is 9c
    from tpusystem_torch.parallel.mesh import PartitionSpec
    from tpusystem_torch.parallel.sharding import TensorParallel
    mesh = MeshSpec(data=-1, model=2).build()
    policy = TensorParallel([(r'kernel$', PartitionSpec(None, 'model'))])
    try:
        policy.place({'kernel': torch.zeros(4, 6)}, mesh)
        out['model_axis'] = None
    except NotImplementedError as error:
        out['model_axis'] = str(error)


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


SCENARIOS = {'layouts': lambda inputs, out: mesh_layouts(out),
             'mlp': train_mlp,
             'collectives': lambda inputs, out: collectives(out),
             'loader': loader_rows, 'lm': masked_lm, 'parity': parity,
             'checkpoint': checkpoints, 'resnet': resnet,
             'guarded': guarded,
             'resharding': resharding, 'wave': wave_drill,
             'double_loss': double_loss}


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
