"""Session-based multi-stream serving hub with coalesced, pipelined ticks.

Counterpart of ``honk_tpu.serve.streams``: N concurrent HTTP clients each
hold a *session*, and all sessions share ONE ``BatchStreamer`` slab, so
every dispatch scores up to ``n_slots`` live streams as one
``(n_slots, 101, 40)`` batch through the MFCC kernel (causal framing) and
the model (res8 / res26: the res-stack kernel).

Protocol (wired into serve/http.py):

    POST /stream/open  {"chunk_samples"?}          -> {"stream_id", "chunk_samples"}
    POST /stream/push  {"stream_id", "wav_data"}   -> {"posterior", "label", "prob", "events"}
    POST /stream/close {"stream_id"}               -> {"events": [...all session events]}
    POST /stream/push_bin  (binary PCM16 frame)    -> {"results": {...}}  (serve/http.py)

The contract is the JAX hub's:

- **Coalesced ticks.** Concurrent ``push_many`` calls merge into one
  pending *tick*: the first arriving thread leads it, waits up to
  ``coalesce_ms`` for the remaining open sessions to join, and dispatches
  ONE masked slab step for all of them. In synchronous mode the leader
  also waits for the previous tick to be applied first, so gateway phases
  that drifted apart re-merge into full-slab ticks.
- **Vectorized detection.** Per tick, event detection for all sessions is
  one numpy pass over the fetched ``(n_slots, n_labels)`` posteriors,
  with slot-indexed cursor and refractory arrays; the score is compared
  with the threshold in float64, so events are byte-identical to
  ``stream.detect_step`` per session.
- **Pipelined mode** (``pipelined=True``): dispatch never waits for
  results. A pool of ``pipeline_depth`` fetcher threads applies completed
  ticks in dispatch order, with at most ``pipeline_depth`` ticks in
  flight (backpressure). A push's response is exactly the session's
  PREVIOUS chunk's result (lag one); the first push returns
  ``{"pending": true}``, and ``close`` flushes, so no event is lost.

Ordering: a session joins a new tick only after its previous tick was
dispatched (pipelined) or applied (sync), so its chunks enter the slab in
ARRIVAL order at ``push_rows``; applies are sequenced by dispatch order
(``_applied_seq``), so cursors advance in chunk order even when fetches
complete out of order.

Failures: if the FETCH of a tick's result fails, the slab has still
consumed its chunks, so the hub advances the sessions' cursors, marks them
``degraded`` and says so on every later push and close of theirs (sync
pushers also get the error). A DISPATCH failure consumed nothing: it
raises to the pushers and rolls each session's chain back to its previous
tick.

Threads: the hub's device work (the host-to-device copy of the chunks, the
step, the slot resets of ``open``, the weight swaps) runs as jobs on the
service's worker thread (``service.worker``), never on the handler thread
that leads a tick; the pipelined fetchers wait on their ticks' events
themselves, and a sync tick's wait is a worker job too. No worker job
takes the hub's lock (a leader holds it while it waits for its dispatch).

On the card: every tick's device work goes on ONE CUDA stream, the
device's current stream when the hub was made, so tick k+1 reads the
state tick k wrote. The JAX package's
device "future" is an event here: at dispatch the posterior rows are
copied without blocking into pinned host memory behind the step, and an
event is recorded; a fetcher waits on that event alone, not on the whole
stream, so later ticks keep running on the card meanwhile. The hub owns
the only slab state; the step writes new state tensors and masked slots
keep theirs bit for bit.

Ranks (``data_axis``, one process per card): the slab's slots are split
over the ranks in blocks (``DataMesh.shard_rows``), every rank holding its
block's state, and every rank builds the hub with the same arguments.

- Rank 0 leads. It holds the sessions, serves HTTP (``make_handler``)
  and runs the ticks, as a hub of one rank does.
- Ranks > 0 follow: they call ``follow()``, which blocks until rank 0's
  ``shutdown()``.
- Each of rank 0's slab jobs (the step of a tick, the slot reset of
  ``open``, a weight swap, ``shutdown``) first becomes a message to the
  followers (``parallel.RankChannel``: the store carries the op, and
  once every follower has it the group carries the chunks as bytes or
  the pickled weights), then runs on every rank: the step's all-gather
  gives every rank every slot's posteriors, and only the rank that holds
  a slot resets it. All of it runs on rank 0's worker thread, so the
  collectives run in one order on every rank.
- Rank 0 validates a push before it sends anything, and fetches its
  rows alone (the followers drop theirs). A follower that died makes
  rank 0's next job raise naming it, after the group's timeout, before
  any collective (on any backend), and every job after it at once.

A world of one rank sends nothing: with ``data_axis`` it is the hub
without it, bit for bit.

Unlike the JAX hub (whose tick history stays reachable and whose empty
push and shutdown race remain there): a tick drops its rollback links
once dispatched and its device result once fetched; ``push_rows`` with no
session returns ``{}`` without dispatching; and ``shutdown`` hands the
fetchers their sentinels under the same lock as every tick, so a tick
dispatched after it is applied by its own leader instead of waiting for a
fetcher that is gone. The JAX hub with ``data_axis`` shards its slab only
under an ambient mesh on the pushing thread: pushed from any other thread
(an HTTP handler's), its step raises.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import uuid
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import StreamConfig
from ..frontend import filters as F
from ..parallel import RankChannel, broadcast_bytes, world_size
from ..stream.streamer import HOP, WINDOW_FRAMES, Detection


class StreamSession:
    __slots__ = ("sid", "slot", "events", "last_tick", "degraded")

    def __init__(self, sid: str, slot: int):
        self.sid = sid
        self.slot = slot
        self.events: list[Detection] = []
        self.last_tick: _Tick | None = None  # most recent tick carrying this session
        self.degraded = False


class _Tick:
    """One coalesced slab dispatch: chunks from one or more push calls."""

    __slots__ = (
        "chunks", "mask", "sessions", "prev_of", "seq", "future", "claimed",
        "dispatched", "done", "error", "fetch_error", "results",
    )

    def __init__(self, n_slots: int, chunk: int, dtype=np.float32):
        self.chunks = np.zeros((n_slots, chunk), dtype)
        self.mask = np.zeros((n_slots,), bool)
        self.sessions: list[StreamSession] = []
        # sid -> the session's previous tick at join time: the rollback
        # target if THIS tick's dispatch fails. Dropped once dispatched, so
        # a long-lived session does not keep its whole tick history.
        self.prev_of: dict[str, "_Tick | None"] | None = {}
        self.seq = -1  # assigned at successful dispatch
        self.future = None  # (host rows, CUDA event or None) until fetched
        self.claimed = False  # exactly one thread fetches+applies
        self.dispatched = threading.Event()
        self.done = threading.Event()  # set once APPLIED (results final)
        self.error: BaseException | None = None  # dispatch failure
        self.fetch_error: BaseException | None = None  # fetch failure
        # sid -> (posterior row, label idx, prob, new events, degraded)
        self.results: dict[str, tuple] = {}


def _start_fetch(post) -> tuple[Any, "torch.cuda.Event | None"]:
    """Queue the device-to-host copy of a tick's posterior rows behind its
    step, into pinned memory, and record an event after it; on the CPU the
    rows are already on the host."""
    if isinstance(post, torch.Tensor) and post.is_cuda:
        host = torch.empty(post.shape, dtype=post.dtype, pin_memory=True)
        host.copy_(post, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return post, None


def _finish_fetch(future) -> np.ndarray:
    """Wait for the tick's copy alone (not the whole stream) and read the rows."""
    host, done = future
    if done is not None:
        done.synchronize()
    return np.asarray(host)


class StreamHub:
    """N concurrent streaming sessions over one shared BatchStreamer slab, on the service's device."""

    def __init__(
        self,
        service,
        n_slots: int = 8,
        cfg: StreamConfig | None = None,
        chunk_samples: int = 3200,
        data_axis: str | None = None,
        coalesce_ms: float = 0.0,
        pipelined: bool = False,
        pipeline_depth: int = 4,
        wire_dtype: str = "float32",
    ):
        self.cfg = cfg or StreamConfig()
        self.chunk = chunk_samples
        self.n_slots = n_slots
        self.labels = service.labels
        self.pipelined = pipelined
        # "int16": ship raw PCM16 to the device and decode there (half the
        # host->device bytes, no host float conversion on the binary path).
        # PCM16-derived float chunks round-trip EXACTLY (i/32768 is a
        # power-of-two division); direct float pushes quantize to the
        # nearest PCM16 step.
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32|int16, got {wire_dtype!r}")
        self.wire_dtype = np.int16 if wire_dtype == "int16" else np.float32
        self._worker = service.worker
        ranks = world_size() if data_axis is not None else 1
        try:
            self._bs = service.make_batch_streamer(n_slots, self.cfg, chunk_samples, data_axis)
        except ValueError as e:
            if ranks == 1:
                raise
            raise ValueError(f"StreamHub(n_slots={n_slots}) over {ranks} ranks: each rank holds a block of the slots, "
                             f"and {e}") from e
        device = self._bs.device
        self._stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self._state = self._worker.run(self._on_stream_call, self._bs.reset)
        # Rank 0's messages to the other ranks (none in a world of one).
        self._channel = RankChannel("stream_hub") if ranks > 1 else None
        self._free = list(range(n_slots))
        self._sessions: dict[str, StreamSession] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: _Tick | None = None
        self._last_tick: _Tick | None = None  # most recently dispatched
        self._next_seq = 0
        self._applied_seq = -1
        self._apply_cv = threading.Condition()
        self._coalesce_s = coalesce_ms / 1000.0
        # Pipelined mode: background fetcher pool + in-flight bound.
        self._depth = max(1, pipeline_depth)
        self._outstanding = 0
        self._fetch_q: "queue.SimpleQueue[_Tick | None] | None" = None
        self._fetchers: list[threading.Thread] = []
        self._on_fetcher = threading.local()  # .yes on the fetcher threads
        self._closed = False  # shutdown() ran: no tick goes to the fetchers after it
        # Slot-indexed detector state (vectorized detect_step, see _apply):
        # windows seen and last-fire window index per slot.
        self._det_i = np.zeros((n_slots,), np.int64)
        self._det_last = np.full((n_slots,), -(10**9), np.int64)
        # Online event times are window-START seconds, like detect_stream:
        # a chunk's causal window ends at its last sample, so shift back by
        # one window length (clamped at 0).
        self.hop_s = chunk_samples / F.SAMPLE_RATE
        self._shift = self.hop_s - WINDOW_FRAMES * HOP / F.SAMPLE_RATE

    def _on_stream(self):
        """The hub's one CUDA stream for the calling thread (nothing on the CPU)."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _on_stream_call(self, fn, *args):
        """``fn(*args)`` on the hub's stream, without autograd: a worker job."""
        with self._on_stream(), torch.no_grad():
            return fn(*args)

    def _follower(self) -> bool:
        return self._channel is not None and not self._channel.leader

    def _refuse_on_follower(self, what: str) -> None:
        if self._follower():
            raise RuntimeError(f"{what} on rank {self._channel.rank}: rank 0 leads the hub, the other ranks follow()")

    def set_variables(self, variables) -> None:
        """Swap the slab's model weights (a state dict in the port's names)
        from the next dispatch on; open sessions keep their state. Rank 0
        sends them to the followers, which swap them at the same point."""
        self._refuse_on_follower("set_variables")
        with self._lock:
            self._worker.run(self._on_stream_call, self._set_variables, variables)

    def _set_variables(self, variables) -> None:
        if self._channel is not None:
            self._channel.send("weights")
            dist.broadcast_object_list([{k: v.detach().cpu() for k, v in variables.items()}], src=0,
                                       device=self._bs.device)
        self._bs.set_variables(variables)

    def _zero_slot(self, slot: int) -> None:
        if self._channel is not None:
            self._channel.send("zero", slot=slot)
        self._zero_rows(slot)

    def _zero_rows(self, slot: int) -> None:
        """Zero ``slot``'s state where it lives: on this rank, if its block holds it."""
        start, stop = self._bs.rows
        if start <= slot < stop:
            for leaf in self._state:  # in place: the hub owns the only state
                leaf[slot - start].zero_()

    def _dispatch(self, chunks: np.ndarray, mask: np.ndarray):
        """The slab step and the start of its rows' fetch: a worker job.
        Returns without waiting for the device."""
        if self._channel is None:
            self._state, post = self._bs.process(self._state, chunks, mask)
            return _start_fetch(post)
        self._channel.send("step", slots=np.flatnonzero(mask).tolist())
        shared = broadcast_bytes(torch.from_numpy(chunks).to(self._bs.device))
        self._state, post = self._bs.process(self._state, shared, mask)
        return _start_fetch(post)

    def follow(self) -> None:
        """Ranks > 0 of a hub over several ranks: replay rank 0's slab jobs
        on this rank's slots, in rank 0's order, until rank 0's
        ``shutdown()``. Blocks; call it right after building the hub."""
        if not self._follower():
            raise ValueError("follow() is for the ranks > 0 of a StreamHub with data_axis in a world of "
                             "several ranks; rank 0 leads (open, push, set_variables, shutdown)")
        self._worker.run(self._on_stream_call, self._follow)

    def _follow(self) -> None:
        channel, dev = self._channel, self._bs.device
        wire = torch.int16 if self.wire_dtype == np.int16 else torch.float32
        while True:
            msg = channel.receive()
            op = msg["op"]
            if op == "step":
                mask = np.zeros((self.n_slots,), bool)
                mask[msg["slots"]] = True
                chunks = broadcast_bytes(torch.empty((self.n_slots, self.chunk), dtype=wire, device=dev))
                self._state, _ = self._bs.process(self._state, chunks, mask)  # rank 0 fetches the rows
            elif op == "zero":
                self._zero_rows(msg["slot"])
            elif op == "weights":
                variables = [None]
                dist.broadcast_object_list(variables, src=0, device=dev)
                self._bs.set_variables(variables[0])
            elif op == "stop":
                return
            else:
                raise RuntimeError(f"rank {channel.rank}: unknown message {msg!r} from rank 0")

    def open(self) -> str:
        self._refuse_on_follower("open")
        with self._lock:
            if not self._free:
                raise RuntimeError(f"all {self.n_slots} stream slots in use")
            slot = self._free.pop()
            sid = uuid.uuid4().hex[:12]
            self._worker.run(self._on_stream_call, self._zero_slot, slot)
            self._det_i[slot] = 0
            self._det_last[slot] = -(10**9)
            self._sessions[sid] = StreamSession(sid, slot)
            return sid

    def push(self, sid: str, chunk: np.ndarray) -> dict[str, Any]:
        """Advance one session by one chunk; returns posterior + new events."""
        return self.push_many({sid: chunk})[sid]

    def push_many(
        self, chunks_by_sid: dict[str, np.ndarray], want_posterior: bool = True
    ) -> dict[str, dict[str, Any]]:
        """Advance SEVERAL sessions; concurrent calls coalesce into one dispatch.

        Returns {sid: {posterior?, label, prob, events, degraded?}}. With
        ``want_posterior=False`` the per-label posterior list is omitted
        (the binary HTTP path).
        """
        if not chunks_by_sid:
            return {}
        sids = list(chunks_by_sid)
        for sid in sids:  # unknown-session beats bad-chunk (KeyError -> 404)
            if sid not in self._sessions:
                raise KeyError(f"unknown stream_id {sid!r}")
        rows = np.empty((len(sids), self.chunk), np.float32)
        for k, sid in enumerate(sids):
            c = np.asarray(chunks_by_sid[sid])
            if c.shape != (self.chunk,):
                raise ValueError(f"chunk must be {self.chunk} samples, got {c.shape}")
            if c.dtype == np.int16:
                # Raw PCM16 scales like _decode_pcm16.
                rows[k] = c.astype(np.float32) / np.float32(32768.0)
            else:
                rows[k] = c
        return self.push_rows(sids, rows, want_posterior)

    def push_rows(
        self, sids: Sequence[str], rows: np.ndarray, want_posterior: bool = True
    ) -> dict[str, dict[str, Any]]:
        """Advance sessions ``sids`` with pre-decoded chunk ``rows``.

        ``rows`` is (len(sids), chunk_samples), float32 or int16: the entry
        the binary HTTP endpoint feeds straight from the request body. No
        session, no dispatch: an empty call returns ``{}``.
        """
        if rows.shape != (len(sids), self.chunk):
            raise ValueError(
                f"rows must be ({len(sids)}, {self.chunk}), got {rows.shape}"
            )
        if not sids:
            return {}
        if len(set(sids)) != len(sids):
            raise ValueError("duplicate stream_id in one push")
        if rows.dtype != self.wire_dtype:
            if rows.dtype == np.int16:
                # Raw PCM16 toward a float wire: the _decode_pcm16 scaling.
                rows = rows.astype(np.float32) / np.float32(32768.0)
            elif self.wire_dtype == np.int16:
                # Float audio toward the int16 wire: exact for PCM16-derived
                # floats (i/32768 * 32768 == i); others quantize.
                rows = np.clip(
                    np.rint(rows.astype(np.float32) * np.float32(32768.0)),
                    -32768, 32767,
                ).astype(np.int16)
            else:
                # e.g. float64 audio with the float32 wire: convert only.
                rows = rows.astype(np.float32)
        while True:
            with self._cv:
                sessions = []
                for sid in sids:
                    sess = self._sessions.get(sid)
                    if sess is None:
                        raise KeyError(f"unknown stream_id {sid!r}")
                    sessions.append(sess)
                # A session joins a new tick only once its previous tick
                # was dispatched (pipelined) / applied (sync).
                blockers = []
                for s in sessions:
                    t = s.last_tick
                    if t is not None:
                        gate = t.dispatched if self.pipelined else t.done
                        if not gate.is_set():
                            blockers.append(t)
                if not blockers:
                    tick = self._pending
                    leader = tick is None
                    if leader:
                        tick = self._pending = _Tick(self.n_slots, self.chunk, self.wire_dtype)
                    # Each session's own previous tick: the pipelined
                    # response waits for exactly that to be applied.
                    prevs = [s.last_tick for s in sessions]
                    for k, sess in enumerate(sessions):
                        tick.chunks[sess.slot] = rows[k]
                        tick.mask[sess.slot] = True
                        tick.sessions.append(sess)
                        tick.prev_of[sess.sid] = sess.last_tick
                        sess.last_tick = tick
                    self._cv.notify_all()  # leader may now have full coverage
                    break
            for t in blockers:  # wait OUTSIDE the lock, then retry
                (t.dispatched if self.pipelined else t.done).wait()
        if leader:
            self._run_tick(tick)
        else:
            (tick.dispatched if self.pipelined else tick.done).wait()
        if tick.error is not None:  # dispatch failed: nothing was consumed
            raise tick.error
        if not self.pipelined:
            if tick.fetch_error is not None:
                raise tick.fetch_error
            return self._format_sync(tick, sids, want_posterior)
        # Lag-1 wait: the previous tick's fetch started a tick ago.
        for t in prevs:
            if t is not None:
                t.done.wait()
        return self._format_pipelined(sids, prevs, want_posterior)

    # ---- tick lifecycle (leader thread) ----

    def _run_tick(self, tick: _Tick) -> None:
        if not self.pipelined:
            # Serialize sync ticks: waiting here (lock NOT held, so the
            # pending tick keeps filling) re-merges gateway phases.
            with self._cv:
                prev = self._last_tick
            if prev is not None:
                prev.done.wait()
        try:
            with self._cv:
                if self._coalesce_s > 0.0:
                    # Wait for the remaining open sessions to join, at most
                    # the coalesce window, and not at all if every open
                    # session is already aboard.
                    deadline = time.monotonic() + self._coalesce_s
                    while int(tick.mask.sum()) < min(self.n_slots, len(self._sessions)):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                if self.pipelined:
                    # Backpressure: bound dispatched-but-unapplied ticks.
                    while self._outstanding >= self._depth:
                        self._cv.wait()
                self._pending = None  # later pushes start the next tick
                try:
                    # Enqueues the step and the copy of its rows on the
                    # worker; returns without waiting for the device.
                    tick.future = self._worker.run(self._on_stream_call, self._dispatch, tick.chunks, tick.mask)
                except BaseException as e:
                    tick.error = e
                    # Nothing was consumed: unwind each session's chain to
                    # its pre-join tick, so the NEXT push still delivers
                    # the previous chunk's (lag-1) result.
                    for sess in tick.sessions:
                        if sess.last_tick is tick:
                            sess.last_tick = tick.prev_of[sess.sid]
                    return  # finally-block unblocks everyone
                tick.seq = self._next_seq
                self._next_seq += 1
                self._outstanding += 1
                self._last_tick = tick
                tick.prev_of = None  # the rollback links are done with
                tick.chunks = None  # the device has its copy
            tick.dispatched.set()
            if not (self.pipelined and self._hand_to_fetchers(tick)):
                self._ensure_applied(tick)
        finally:
            # No waiter may hang, whatever failed above.
            tick.dispatched.set()
            if tick.error is not None or not self.pipelined:
                tick.done.set()

    def _hand_to_fetchers(self, tick: _Tick) -> bool:
        """Queue a dispatched tick for the fetcher pool (started on first
        use); False after ``shutdown``, when the caller applies it itself."""
        with self._cv:
            if self._closed:
                return False
            if self._fetch_q is None:
                self._fetch_q = queue.SimpleQueue()
                for i in range(self._depth):
                    th = threading.Thread(target=self._fetch_loop, args=(self._fetch_q,),
                                          name=f"hub-fetch-{i}", daemon=True)
                    th.start()
                    self._fetchers.append(th)
            self._fetch_q.put(tick)
            return True

    def _fetch_loop(self, q: "queue.SimpleQueue[_Tick | None]") -> None:
        # Several fetchers wait concurrently; _ensure_applied still applies
        # ticks strictly in dispatch order.
        self._on_fetcher.yes = True
        while True:
            tick = q.get()
            if tick is None:  # shutdown sentinel
                return
            try:
                self._ensure_applied(tick)
            except BaseException:  # pragma: no cover - belt and braces:
                # a dead fetcher would strand later ticks; errors are
                # already recorded on the tick (fetch_error) for callers.
                pass
            del tick  # an idle fetcher keeps no tick alive

    def shutdown(self) -> None:
        """Stop the background fetcher pool (pipelined mode) and wait for it;
        on rank 0 of several, then stop the followers (their ``follow()``
        returns) and wait until each has the message.

        Ticks already queued are applied before the threads exit: the
        sentinels go in behind them, under the lock that queues ticks, and
        ticks dispatched later are applied by their own leaders (over
        several ranks, such a tick's dispatch raises: the followers are
        gone). Idempotent; raises if a follower could not be stopped.
        """
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if self._fetch_q is not None:
                for _ in self._fetchers:
                    self._fetch_q.put(None)
            fetchers, self._fetchers = self._fetchers, []
        for th in fetchers:
            th.join(timeout=60)
        if self._channel is not None and self._channel.leader:
            self._worker.run(self._on_stream_call, self._channel.stop)

    def _ensure_applied(self, tick: _Tick) -> None:
        """Fetch + apply ``tick`` exactly once; all other callers wait."""
        with self._cv:
            claim = not tick.claimed
            tick.claimed = True
        if not claim:
            tick.done.wait()
            return
        try:
            fetched = None
            try:
                # Waits on the tick's event, no lock held: a fetcher itself,
                # any other thread through the worker.
                if getattr(self._on_fetcher, "yes", False):
                    fetched = _finish_fetch(tick.future)
                else:
                    fetched = self._worker.run(_finish_fetch, tick.future)
            except BaseException as e:
                # Fetch failed but the device consumed the chunks ->
                # degraded-cursor semantics in _apply.
                tick.fetch_error = e
            tick.future = None  # drop the device result and its pinned rows
            with self._apply_cv:
                # Applies are globally sequenced by dispatch order.
                while self._applied_seq != tick.seq - 1:
                    self._apply_cv.wait()
                try:
                    self._apply(tick, fetched)
                except BaseException as e:
                    # Surfaced like a fetch failure (sync pushers raise it;
                    # pipelined sessions see degraded/pending).
                    tick.fetch_error = e
                finally:
                    # The seq chain ALWAYS advances: a wedged chain would
                    # block every later tick's apply and hang the hub.
                    self._applied_seq = tick.seq
                    self._apply_cv.notify_all()
        finally:
            tick.done.set()
            with self._cv:
                self._outstanding -= 1
                self._cv.notify_all()

    def _apply(self, tick: _Tick, fetched: np.ndarray | None) -> None:
        """Vectorized detect_step over every session in the tick.

        One numpy pass computes argmax/threshold/refractory for all
        sessions (slot-indexed cursor arrays); only firing sessions touch
        Python-level event objects. Runs under ``_apply_cv``.
        """
        sess_list = tick.sessions
        slots = np.fromiter((s.slot for s in sess_list), np.int64, len(sess_list))
        if fetched is None:
            # Fetch failed: advance the cursors so later event times stay
            # aligned with the device posterior history.
            self._det_i[slots] += 1
            for sess in sess_list:
                sess.degraded = True
            return
        rows = fetched[slots]  # (k, n_labels)
        labs = rows.argmax(axis=1)
        k = len(sess_list)
        # float64, matching detect_step's `float(probs[label])` compare:
        # numpy's weak scalar promotion would compare in float32, and a
        # score within 1 ULP of the threshold could diverge.
        scores = rows[np.arange(k), labs].astype(np.float64)
        i_vals = self._det_i[slots]
        fire = (
            (labs >= 2)  # a keyword wins the window (not silence/unknown)
            & (scores >= self.cfg.detection_threshold)
            & (i_vals - self._det_last[slots] >= self.cfg.min_gap_windows)
        )
        self._det_i[slots] = i_vals + 1
        if fire.any():
            self._det_last[slots[fire]] = i_vals[fire]
        for j, sess in enumerate(sess_list):
            new: list[Detection] = []
            if fire[j]:
                e = Detection(
                    time_s=max(0.0, float(i_vals[j]) * self.hop_s + self._shift),
                    label=int(labs[j]),
                    score=float(scores[j]),
                )
                sess.events.append(e)
                new = [e]
            tick.results[sess.sid] = (
                rows[j], int(labs[j]), float(scores[j]), new, sess.degraded
            )

    # ---- response formatting ----

    def _format_sync(
        self, tick: _Tick, sids: Sequence[str], want_posterior: bool
    ) -> dict[str, dict[str, Any]]:
        return self._format([tick.results[sid] for sid in sids], sids, want_posterior)

    def _format_pipelined(
        self, sids: Sequence[str], prevs: Sequence["_Tick | None"], want_posterior: bool
    ) -> dict[str, dict[str, Any]]:
        # Lag-1 contract: each session's response is its OWN previous
        # tick's applied result, looked up directly on that tick.
        picked: list[tuple | None] = [
            None if prev is None else prev.results.get(sid)
            for sid, prev in zip(sids, prevs)
        ]
        out = self._format(
            [r for r in picked if r is not None],
            [sid for sid, r in zip(sids, picked) if r is not None],
            want_posterior,
        )
        for sid, prev, r in zip(sids, prevs, picked):
            if r is None:
                d: dict[str, Any] = {"pending": True, "events": []}
                if prev is not None:
                    # The previous tick applied but produced no result for
                    # this session: its fetch failed.
                    d["degraded"] = True
                out[sid] = d
        return out

    def _format(
        self, results: list[tuple], sids: Sequence[str], want_posterior: bool
    ) -> dict[str, dict[str, Any]]:
        out: dict[str, dict[str, Any]] = {}
        plist = None
        if want_posterior and results:
            # One vectorized rounding pass (float64 first: np.round then
            # matches Python round() on the JSON surface).
            rows = np.stack([r[0] for r in results]).astype(np.float64)
            plist = np.round(rows, 6).tolist()
        for j, (sid, res) in enumerate(zip(sids, results)):
            _row, lab, prob, new, degraded = res
            d: dict[str, Any] = {
                "label": self.labels[lab],
                "prob": prob,
                "events": [self._event_json(e) for e in new],
            }
            if want_posterior:
                d["posterior"] = plist[j]
            if degraded:
                d["degraded"] = True
            out[sid] = d
        return out

    def close(self, sid: str) -> dict[str, Any]:
        with self._lock:
            sess = self._sessions.pop(sid, None)
            if sess is None:
                raise KeyError(f"unknown stream_id {sid!r}")
            tick = sess.last_tick
        if tick is not None:
            # Flush: wait for the dispatch that captured this session (its
            # slab write must land before a successor's slot reset) and,
            # pipelined, fetch/apply it if nobody else will.
            tick.dispatched.wait()
            if tick.error is None:
                self._ensure_applied(tick)
            else:
                tick.done.wait()
        with self._cv:
            self._free.append(sess.slot)
            self._cv.notify_all()  # open-session count changed (leader predicate)
        out: dict[str, Any] = {"events": [self._event_json(e) for e in sess.events]}
        if sess.degraded:
            out["degraded"] = True
        return out

    def _event_json(self, e: Detection) -> dict[str, Any]:
        return {"time_s": round(e.time_s, 3), "label": self.labels[e.label], "prob": round(e.score, 4)}
