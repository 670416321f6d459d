"""TensorBoard scalar logging without the tensorboard package. The port
of :mod:`tpusystem.observe.tensorboard`, copied: its event files are
byte for byte the reference's for the same scalars and clock.

The reference uses ``torch.utils.tensorboard.SummaryWriter``
(``examples/tinysys/tinysys/services/tensorboard.py``); this environment
ships no tensorboard, so the writer speaks the on-disk format directly —
it is small and stable:

* an event file is a **TFRecord** stream: for each record,
  ``uint64 length | uint32 masked-crc32c(length) | payload |
  uint32 masked-crc32c(payload)``;
* each payload is a serialized ``tensorflow.Event`` protobuf: field 1
  ``wall_time`` (double), field 2 ``step`` (int64), field 3
  ``file_version`` (string, first record only), field 5 ``summary`` —
  a ``Summary`` of repeated ``Summary.Value`` {tag: field 1, simple_value:
  field 2}.

Both are hand-encoded here (varint/fixed encoders + a table-driven CRC32C),
so any TensorBoard install can read the runs this framework writes.
"""

from __future__ import annotations

import os
import pathlib
import socket
import struct
import time

from tpusystem_torch.observe.events import (AnomalyDetected, BackoffApplied,
                                      Backpressure, CapacityArbitrated,
                                      ElasticTimeline, EngineRestarted,
                                      FleetResized, HandoffCorrupted,
                                      JobAdmitted, JobHalted, JobPreempted,
                                      LoadShed, PrefillHandoff,
                                      RecoveryTimeline, RecsysEvaluated,
                                      ReplicaDiverged, ReplicaUnhealthy,
                                      RequestAdmitted, RequestExpired,
                                      RequestRerouted, RoleMismatched,
                                      RolledBack, RouterTakeover,
                                      ServeStepped, Trained, Validated,
                                      WorkerExited, WorldResized)
from tpusystem_torch.services.prodcon import Consumer, Depends

# ---------------------------------------------------------------- crc32c ---

_CRC_TABLE = []
for _index in range(256):
    _crc = _index
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)  # Castagnoli poly
    _CRC_TABLE.append(_crc)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf ---

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack('<d', value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', value)


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    summary_value = (_bytes_field(1, tag.encode()) + _float_field(2, value))
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time) + _int_field(2, step)
            + _bytes_field(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _bytes_field(3, b'brain.Event:2')


# --------------------------------------------------------------- writer ---

class SummaryWriter:
    """Append-only TensorBoard event-file writer for scalar curves."""

    def __init__(self, logdir: str | os.PathLike) -> None:
        self.logdir = pathlib.Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        stamp = time.time()
        name = f'events.out.tfevents.{stamp:.0f}.{socket.gethostname()}.{os.getpid()}'
        self._handle = open(self.logdir / name, 'ab')
        self._record(_version_event(stamp))
        self.flush()

    def _record(self, payload: bytes) -> None:
        header = struct.pack('<Q', len(payload))
        self._handle.write(header)
        self._handle.write(struct.pack('<I', _masked_crc(header)))
        self._handle.write(payload)
        self._handle.write(struct.pack('<I', _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(tag, float(value), int(step), time.time()))

    def add_scalars(self, main_tag: str, values: dict[str, float], step: int) -> None:
        """Scalars under ``{main_tag}/{name}`` (flat-file variant of the
        torch API the reference calls — ``tensorboard.py:17-19``)."""
        for name, value in values.items():
            self.add_scalar(f'{main_tag}/{name}', value, step)

    def flush(self) -> None:
        self._handle.flush()

    def close(self) -> None:
        self._handle.flush()
        self._handle.close()


# ------------------------------------------------------------- consumer ---

def writer() -> SummaryWriter:
    """DI seam for the summary writer — override at the composition root::

        def tensorboard():            # generator dep: flushes on teardown
            writer = SummaryWriter('data/runs')
            yield writer
            writer.close()
        consumer.dependency_overrides[writer] = tensorboard
    """
    raise NotImplementedError('override the tensorboard writer dependency')


def tensorboard_consumer() -> Consumer:
    """Consumer charting ``{model.id}/{metric}`` per phase at each epoch."""
    consumer = Consumer('tensorboard')

    @consumer.handler
    def on_metrics(event: Trained | Validated,
                   board: SummaryWriter = Depends(writer)) -> None:
        phase = 'train' if isinstance(event, Trained) else 'evaluation'
        for name, value in event.metrics.items():
            board.add_scalar(f'{event.model.id}/{name}/{phase}', value,
                             getattr(event.model, 'epoch', 0))

    def _subject(model) -> str:
        return str(getattr(model, 'id', model))

    # recommender quality at phase cadence: the streaming evaluator's
    # rank metrics (auc / recall@k) charted per epoch next to the loss,
    # so a ranking regression reads straight off the dashboard

    @consumer.handler
    def on_recsys_evaluated(event: RecsysEvaluated,
                            board: SummaryWriter = Depends(writer)) -> None:
        epoch = getattr(event.model, 'epoch', 0)
        for name, value in event.metrics.items():
            board.add_scalar(f'{_subject(event.model)}/recsys/{name}',
                             value, epoch)

    # sentinel ladder: each transition charted at its global step, so a
    # loss-spike investigation reads straight off the run's dashboard

    @consumer.handler
    def on_anomaly(event: AnomalyDetected,
                   board: SummaryWriter = Depends(writer)) -> None:
        tag = f'{_subject(event.model)}/sentinel'
        board.add_scalar(f'{tag}/anomaly', 1.0, event.step)
        if event.kind == 'spike':     # non-finite values break TB charts
            board.add_scalar(f'{tag}/spike_zscore', event.zscore, event.step)

    @consumer.handler
    def on_backoff(event: BackoffApplied,
                   board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar(f'{_subject(event.model)}/sentinel/lr_scale',
                         event.scale, event.step)

    @consumer.handler
    def on_rollback(event: RolledBack,
                    board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar(f'{_subject(event.model)}/sentinel/rollback_to',
                         float(event.to_step), event.step)

    @consumer.handler
    def on_replica_diverged(event: ReplicaDiverged,
                            board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar(f'{_subject(event.model)}/sentinel/sdc_replicas',
                         float(len(event.replicas)), event.step or 0)

    # supervisor recovery loop: worker exits and full detect→first-step
    # MTTR, charted per rank so a restart storm or a slow restore reads
    # straight off the dashboard. Exits have no global step, so they are
    # charted against a per-rank exit counter — ten crash-loop exits read
    # as ten points, not one overplotted pile at x=0.
    exit_counts: dict[int, int] = {}

    @consumer.handler
    def on_worker_exited(event: WorkerExited,
                         board: SummaryWriter = Depends(writer)) -> None:
        exit_counts[event.rank] = exit_counts.get(event.rank, 0) + 1
        board.add_scalar(f'supervisor/rank{event.rank}/exit_code',
                         float(event.code), exit_counts[event.rank])

    # serving engine: queue depth and throughput per scheduler step, and
    # time-to-first-token per admission (charted against an admission
    # counter — requests have no global step), so a latency or backlog
    # incident reads straight off the dashboard
    admit_counts = [0]

    @consumer.handler
    def on_request_admitted(event: RequestAdmitted,
                            board: SummaryWriter = Depends(writer)) -> None:
        admit_counts[0] += 1
        board.add_scalar('serve/ttft_seconds', event.ttft, admit_counts[0])
        board.add_scalar('serve/queue_depth_at_admit',
                         float(event.queue_depth), admit_counts[0])

    @consumer.handler
    def on_serve_stepped(event: ServeStepped,
                         board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar('serve/queue_depth', float(event.queue_depth),
                         event.step)
        board.add_scalar('serve/active_rows', float(event.active),
                         event.step)
        board.add_scalar('serve/tok_s', event.tokens_per_sec, event.step)
        # sampled-traffic gauge (getattr: replayed event streams may
        # carry pre-sampling ServeStepped payloads without the field)
        board.add_scalar('serve/sampled_rows',
                         float(getattr(event, 'sampled', 0)), event.step)

    # deadline expiries: charted against an expiry counter (requests have
    # no global step), split by where the request died — a queue full of
    # expiries reads as saturation, active expiries as slow decode
    expire_counts = [0]

    @consumer.handler
    def on_request_expired(event: RequestExpired,
                           board: SummaryWriter = Depends(writer)) -> None:
        expire_counts[0] += 1
        board.add_scalar('serve/expired_total', float(expire_counts[0]),
                         expire_counts[0])
        board.add_scalar(f'serve/expired_waited_{event.where}',
                         event.waited, expire_counts[0])

    # serving failover: engine relaunches (recovery MTTR + how many rows
    # replayed hot vs resubmitted cold), watermark sheds, and the
    # backpressure flag — a chaos incident or an overload wave reads
    # straight off the dashboard. Restarts and sheds have no global
    # step, so they chart against their own counters.
    restart_counts = [0]
    shed_counts = [0]
    backpressure_counts = [0]

    @consumer.handler
    def on_engine_restarted(event: EngineRestarted,
                            board: SummaryWriter = Depends(writer)) -> None:
        restart_counts[0] += 1
        board.add_scalar('serve/recovery_seconds', event.seconds,
                         restart_counts[0])
        board.add_scalar('serve/replayed', float(event.replayed),
                         restart_counts[0])
        board.add_scalar('serve/resubmitted', float(event.resubmitted),
                         restart_counts[0])

    @consumer.handler
    def on_load_shed(event: LoadShed,
                     board: SummaryWriter = Depends(writer)) -> None:
        # per shed event (x = shed counter): the queue depth that
        # triggered it — how overloaded the replica actually was — and
        # the victim's remaining deadline slack where it had one
        shed_counts[0] += 1
        board.add_scalar('serve/shed', float(event.queue_depth or 0),
                         shed_counts[0])
        if event.slack is not None:
            board.add_scalar('serve/shed_slack', event.slack,
                             shed_counts[0])

    @consumer.handler
    def on_backpressure(event: Backpressure,
                        board: SummaryWriter = Depends(writer)) -> None:
        backpressure_counts[0] += 1
        board.add_scalar('serve/backpressure',
                         1.0 if event.engaged else 0.0,
                         backpressure_counts[0])

    # fleet tier: health verdicts, reroutes and resizes have no global
    # step, so each charts against its own counter — a failover incident
    # (verdict → N reroutes → maybe a grow) reads straight off the
    # fleet/* dashboard next to the per-replica serve/* rows
    unhealthy_counts = [0]
    reroute_counts = [0]
    resize_counts = [0]

    @consumer.handler
    def on_replica_unhealthy(event: ReplicaUnhealthy,
                             board: SummaryWriter = Depends(writer)) -> None:
        unhealthy_counts[0] += 1
        board.add_scalar('fleet/unhealthy_total', float(unhealthy_counts[0]),
                         unhealthy_counts[0])
        board.add_scalar('fleet/rehomed_requests', float(event.routed),
                         unhealthy_counts[0])

    @consumer.handler
    def on_request_rerouted(event: RequestRerouted,
                            board: SummaryWriter = Depends(writer)) -> None:
        reroute_counts[0] += 1
        board.add_scalar('fleet/rerouted_total', float(reroute_counts[0]),
                         reroute_counts[0])
        # per reroute: how much already-emitted work the hot handoff
        # carried over (0 = a cold re-submit re-decodes everything)
        board.add_scalar('fleet/reroute_prefix', float(event.prefix),
                         reroute_counts[0])

    @consumer.handler
    def on_fleet_resized(event: FleetResized,
                         board: SummaryWriter = Depends(writer)) -> None:
        resize_counts[0] += 1
        board.add_scalar('fleet/replicas', float(event.replicas),
                         resize_counts[0])

    handoff_counts = [0]

    @consumer.handler
    def on_prefill_handoff(event: PrefillHandoff,
                           board: SummaryWriter = Depends(writer)) -> None:
        handoff_counts[0] += 1
        board.add_scalar('fleet/handoffs_total', float(handoff_counts[0]),
                         handoff_counts[0])
        # the KV weight each disaggregated move ships over the blob
        # plane — the interconnect cost of splitting prefill from decode
        board.add_scalar('fleet/handoff_bytes', float(event.bytes),
                         handoff_counts[0])

    # disaggregation integrity + router takeover: each of these SHOULD
    # chart flat at zero (corrupt handoffs and role mismatches are
    # recovered typed, but a rising rate means the blob plane or the
    # role map is sick); a takeover charts its MTTR ingredients
    corrupt_counts = [0]
    mismatch_counts = [0]
    takeover_counts = [0]

    @consumer.handler
    def on_handoff_corrupted(event: HandoffCorrupted,
                             board: SummaryWriter = Depends(writer)) -> None:
        corrupt_counts[0] += 1
        board.add_scalar('serve/handoff_corrupt', float(corrupt_counts[0]),
                         corrupt_counts[0])

    @consumer.handler
    def on_role_mismatched(event: RoleMismatched,
                           board: SummaryWriter = Depends(writer)) -> None:
        mismatch_counts[0] += 1
        board.add_scalar('serve/role_mismatch', float(mismatch_counts[0]),
                         mismatch_counts[0])

    @consumer.handler
    def on_router_takeover(event: RouterTakeover,
                           board: SummaryWriter = Depends(writer)) -> None:
        takeover_counts[0] += 1
        board.add_scalar('fleet/takeover_seconds', event.seconds,
                         takeover_counts[0])
        board.add_scalar('fleet/takeover_reseated', float(event.reseated),
                         takeover_counts[0])
        board.add_scalar('fleet/takeover_replaced', float(event.replaced),
                         takeover_counts[0])
        # 1.0 = the router journal survived (hot rebuild); 0.0 = the
        # health sweep alone rebuilt the tables (cold)
        board.add_scalar('fleet/takeover_hot',
                         1.0 if event.source == 'journal' else 0.0,
                         takeover_counts[0])

    @consumer.handler
    def on_recovery(event: RecoveryTimeline,
                    board: SummaryWriter = Depends(writer)) -> None:
        tag = f'supervisor/rank{event.rank}/recovery_seconds'
        board.add_scalar(tag, event.seconds, event.step or 0)
        if event.source is not None:     # 1.0 = hot (RAM), 0.0 = disk
            board.add_scalar(f'supervisor/rank{event.rank}/restore_hot',
                             1.0 if event.source == 'hot' else 0.0,
                             event.step or 0)

    # elastic resizes: world size over membership epochs plus the two
    # latencies that matter — wave-open → commit (the settle/agreement
    # cost) and wave-open → resumed (the whole reshard) — so a
    # preemption-wave incident reads straight off the dashboard
    @consumer.handler
    def on_world_resized(event: WorldResized,
                         board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar('elastic/world_size', float(event.size), event.epoch)
        board.add_scalar('elastic/commit_seconds', event.seconds, event.epoch)

    @consumer.handler
    def on_elastic_timeline(event: ElasticTimeline,
                            board: SummaryWriter = Depends(writer)) -> None:
        board.add_scalar('elastic/resize_seconds', event.seconds, event.epoch)
        if event.source is not None:   # 1.0 = hot reshard (RAM), 0.0 = disk
            board.add_scalar('elastic/reshard_hot',
                             1.0 if event.source == 'hot-reshard' else 0.0,
                             event.epoch)

    # orchestrator/* dashboard — the multi-tenant gang narrative; the
    # events are step-less (admissions and arbitrations are sparse), so
    # they chart against closure counters like the fleet/* rows. Wire
    # one tensorboard_consumer per tenant through a NamespacedWriter
    # override ({tenant}/serve/..., {tenant}/train/...) for per-tenant
    # charts; the orchestrator/* rows below are fleet-of-jobs facts and
    # belong on the shared (un-prefixed) board.
    admit_counts = [0]
    halt_counts = [0]
    preempt_counts = [0]
    arbitrate_counts = [0]

    @consumer.handler
    def on_job_admitted(event: JobAdmitted,
                        board: SummaryWriter = Depends(writer)) -> None:
        admit_counts[0] += 1
        board.add_scalar('orchestrator/jobs_admitted',
                         float(admit_counts[0]), admit_counts[0])
        board.add_scalar('orchestrator/admitted_chips', float(event.chips),
                         admit_counts[0])

    @consumer.handler
    def on_job_halted(event: JobHalted,
                      board: SummaryWriter = Depends(writer)) -> None:
        halt_counts[0] += 1
        board.add_scalar('orchestrator/jobs_halted', float(halt_counts[0]),
                         halt_counts[0])
        board.add_scalar('orchestrator/halt_code', float(event.code),
                         halt_counts[0])

    @consumer.handler
    def on_job_preempted(event: JobPreempted,
                         board: SummaryWriter = Depends(writer)) -> None:
        preempt_counts[0] += 1
        board.add_scalar('orchestrator/preemptions',
                         float(preempt_counts[0]), preempt_counts[0])
        board.add_scalar('orchestrator/preempted_chips', float(event.chips),
                         preempt_counts[0])

    @consumer.handler
    def on_capacity_arbitrated(event: CapacityArbitrated,
                               board: SummaryWriter = Depends(writer)
                               ) -> None:
        arbitrate_counts[0] += 1
        board.add_scalar('orchestrator/arbitrations',
                         float(arbitrate_counts[0]), arbitrate_counts[0])
        board.add_scalar('orchestrator/arbitration_seconds', event.seconds,
                         arbitrate_counts[0])

    return consumer
