"""Streaming continuous keyword detection over long or unbounded audio.

Counterpart of ``honk_tpu.stream.streamer`` (reference ``service.py::stride``
and ``utils/speech_demo.py``: overlapping 1 s windows scored every hop,
posteriors smoothed, then thresholded), name for name, on the port's
kernels:

- **Offline** (``stream_file``): every 10 ms MFCC frame of the long audio
  is computed once, by one launch of the MFCC kernel in its center framing
  (reflect padding, as the utterance frontend). The overlapping 101-frame
  windows are a view over the frame axis, and the model scores them all in
  one call (res8 / res26: one res-stack launch).
- **Online** (``Streamer``, ``BatchStreamer``): fixed-size chunks feed a
  device-resident feature ring. Each step frames only its own new frames
  from ``[480-sample tail | chunk]`` with the MFCC kernel's causal framing
  (no padding: the last 160 samples belong to the next step's first
  frame), rolls them into the ring, scores the window and pushes the
  posterior into the smoothing ring. The state is a ``StreamState`` of
  fixed-shape device tensors, O(1) in the stream's length.

Posterior smoothing is the mean of the last ``smoothing_window`` window
posteriors; a detection fires when a keyword label is the argmax of the
smoothed posterior and at least ``detection_threshold``, with a global
refractory gap of ``min_gap_windows`` windows. Event detection is
host-side numpy, as in the JAX package, so events are the same bytes.

Weights: ``variables`` is None (the model's own weights) or a state dict
in the port's names (a honk ``.pt``, ``from_flax_variables``). A streamer
given weights, or swapping them with ``set_variables``, loads them into its
own copy of the model, so the caller's model (a ``LabelService``'s) keeps
its weights. The model's ``eval_operands()`` are computed once per set of
weights.

Data parallel (the JAX package's ``data_axis``): ``data_axis`` names the
axis of the mesh over the process group's ranks (``parallel.make_data_mesh``;
a world of one without a group). ``stream_file`` pads its windows to a
multiple of the ranks, each rank scores its block and an all-gather puts
them back in order; a ``BatchStreamer`` holds only its rank's rows of the
stream axis and its ``process`` is collective. Both equal the unsharded run.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import StreamConfig
from ..frontend import filters as F
from ..metrics.profiling import annotate
from ..models import load_state_dict
from ..ops.mfcc_kernel import mfcc
from ..parallel import make_data_mesh

WINDOW_FRAMES = F.N_FRAMES  # 101
HOP = F.HOP_LENGTH  # 160
NFFT = F.N_FFT  # 480


def frame_mfccs(audio: torch.Tensor) -> torch.Tensor:
    """All center-framed MFCC frames of arbitrary-length audio: (L,) -> (1 + L // 160, 40).

    One launch of the MFCC kernel on a CUDA tensor (its plain version on a CPU one).
    """
    return mfcc(audio.to(torch.float32).reshape(1, -1).contiguous(), center=True)[0]


def smooth_posteriors(post: torch.Tensor, w: int) -> torch.Tensor:
    """Trailing mean over the window axis: (n, L) -> (n, L).

    The JAX package's formula: a cumulative sum with a zero row in front,
    and each row the difference of two of its rows over the count. A
    direct trailing sum would differ from it by the cumsum's cancellation
    error, which grows with the stream's length.
    """
    n = post.shape[0]
    cs = torch.cumsum(post, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    idx = torch.arange(n, device=post.device)
    starts = torch.clamp(idx - w + 1, min=0)
    counts = (idx - starts + 1).to(post.dtype)
    return (cs[idx + 1] - cs[starts]) / counts[:, None]


@dataclasses.dataclass
class Detection:
    time_s: float
    label: int
    score: float


@dataclasses.dataclass
class DetectorState:
    """O(1) cursor for incremental event detection: the window index and the
    last fire index, exactly what ``detect`` threads through its loop."""

    i: int = 0
    last_fire: int = -(10**9)


def detect_step(
    probs: np.ndarray, st: DetectorState, cfg: StreamConfig, hop_s: float
) -> Detection | None:
    """Advance the detector by ONE smoothed posterior row.

    A detection fires only when a keyword label (not ``__silence__`` /
    ``__unknown__``) is both the argmax of the smoothed posterior and at
    least ``detection_threshold`` (compared in float64, as Python floats),
    and at least ``min_gap_windows`` windows after the previous fire of any
    label. ``time_s`` is the START of the 1 s detection window.
    """
    i = st.i
    st.i += 1
    label = int(probs.argmax())
    if label < 2:  # silence/unknown wins the window -> no detection
        return None
    score = float(probs[label])
    if score < cfg.detection_threshold:
        return None
    if i - st.last_fire < cfg.min_gap_windows:
        return None
    st.last_fire = i
    return Detection(time_s=i * hop_s, label=label, score=score)


def detect(smoothed: np.ndarray, cfg: StreamConfig, hop_s: float) -> list[Detection]:
    """Threshold smoothed posteriors into detection events (batch form of ``detect_step``)."""
    st = DetectorState()
    events: list[Detection] = []
    for i in range(smoothed.shape[0]):
        e = detect_step(smoothed[i], st, cfg, hop_s)
        if e is not None:
            events.append(e)
    return events


class StreamDetector:
    """Incremental online detector: one smoothed row per chunk, O(1) state.

    ``detect_step`` with ``detect_stream``'s window-start time shift, so a
    session that feeds each ``Streamer`` posterior as it arrives emits the
    events ``detect_stream`` gives over the whole series.
    """

    def __init__(self, cfg: StreamConfig, chunk_samples: int):
        self.cfg = cfg
        self.hop_s = chunk_samples / F.SAMPLE_RATE
        self._shift = self.hop_s - WINDOW_FRAMES * HOP / F.SAMPLE_RATE
        self._st = DetectorState()

    def step(self, probs: np.ndarray) -> Detection | None:
        e = detect_step(probs, self._st, self.cfg, self.hop_s)
        if e is None:
            return None
        return Detection(time_s=max(0.0, e.time_s + self._shift), label=e.label, score=e.score)


def detect_stream(
    smoothed_series: np.ndarray, cfg: StreamConfig, chunk_samples: int
) -> list[Detection]:
    """Detection events from an online smoothed-posterior series.

    ``smoothed_series[c]`` is the posterior after chunk ``c``; that step's
    causal window ends at sample ``(c + 1) * chunk_samples``, so event
    times are shifted back by one window to be window-start seconds, like
    ``detect`` / ``stream_file``.
    """
    hop_s = chunk_samples / F.SAMPLE_RATE
    shift = hop_s - WINDOW_FRAMES * HOP / F.SAMPLE_RATE  # ~ chunk - 1 s
    events = detect(np.asarray(smoothed_series), cfg, hop_s)
    return [
        Detection(time_s=max(0.0, e.time_s + shift), label=e.label, score=e.score)
        for e in events
    ]


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def stream_file(
    model: torch.nn.Module,
    variables,
    audio: np.ndarray,
    cfg: StreamConfig | None = None,
    data_axis: str | None = None,
    packed=None,
) -> tuple[np.ndarray, list[Detection]]:
    """Offline continuous detection over a long mono waveform, on the model's device.

    Returns (smoothed posteriors (n_windows, n_labels) as numpy, detections).
    Audio shorter than one window gives ``(np.zeros((0, 1)), [])`` before
    any MFCC. ``packed`` is the model's ``eval_operands()`` for its own
    weights (``variables=None``), where the caller has them already. With
    ``data_axis``, every rank calls this with the same audio: the windows
    are padded to a multiple of the ranks, each scores its block, and the
    padding is dropped after the all-gather.
    """
    cfg = cfg or StreamConfig()
    hop_frames = cfg.hop_samples // HOP
    audio = np.asarray(audio, np.float32)
    n_frames = 1 + audio.shape[0] // HOP
    n_windows = max(0, (n_frames - WINDOW_FRAMES) // hop_frames + 1)
    if n_windows == 0:
        return np.zeros((0, 1)), []
    if variables is not None:  # a copy of the model holds them
        model, packed = load_state_dict(copy.deepcopy(model), variables).eval(), None
    with torch.no_grad():
        if packed is None:
            packed = model.eval_operands()
        with annotate("stream_copy"):
            wave = torch.from_numpy(audio).to(_device(model))
        feats = frame_mfccs(wave)  # each frame computed once
        # (n_windows, 40, 101) view over the frame axis -> (n_windows, 101, 40)
        windows = feats.unfold(0, WINDOW_FRAMES, hop_frames).transpose(1, 2)
        with annotate("stream_forward"):
            if data_axis is None:
                post = torch.softmax(model(windows.contiguous(), packed=packed), dim=-1)
            else:
                mesh = make_data_mesh(0, data_axis)
                n_padded = -(-n_windows // mesh.size) * mesh.size
                start, stop = mesh.shard_rows(n_padded)
                mine = windows[start:min(stop, n_windows)]
                if stop > n_windows:  # the padding: zero windows, dropped below
                    mine = torch.cat([mine, mine.new_zeros((stop - max(start, n_windows),) + mine.shape[1:])])
                post = torch.softmax(model(mine.contiguous(), packed=packed), dim=-1)
                post = mesh.all_gather_rows(post, n_padded)[:n_windows]
        smoothed = smooth_posteriors(post, cfg.smoothing_window).cpu().numpy()
    hop_s = cfg.hop_samples / F.SAMPLE_RATE
    with annotate("stream_detect"):
        return smoothed, detect(smoothed, cfg, hop_s)


class StreamState(NamedTuple):
    """Fixed-shape device-resident streaming state (O(1) in stream length).

    Shapes are a ``Streamer``'s; a ``BatchStreamer``'s have a leading stream axis.
    """

    sample_tail: torch.Tensor  # (NFFT,) last samples for framing context
    feat_ring: torch.Tensor  # (WINDOW_FRAMES, 40) rolling feature window
    post_ring: torch.Tensor  # (smoothing_window, n_labels) recent posteriors
    frames_seen: torch.Tensor  # () int32
    windows_seen: torch.Tensor  # () int32


class Streamer:
    """Online chunked streaming: one step per fixed-size chunk.

    Chunk size must be a multiple of the 10 ms frame hop and at most one
    window. Each step computes MFCCs for the chunk's new frames only (the
    MFCC kernel's causal framing), rolls them into the feature ring, scores
    the window (res8 / res26: the res-stack kernel) and pushes the
    posterior into the smoothing ring. int16 chunks go to the device as
    they are and are decoded there, ``x * (1 / 32768)``.
    """

    def __init__(self, model: torch.nn.Module, variables, cfg: StreamConfig | None = None,
                 chunk_samples: int = 3200):
        if chunk_samples % HOP or not HOP <= chunk_samples <= WINDOW_FRAMES * HOP:
            raise ValueError(f"chunk must be a multiple of the {HOP}-sample hop, at most one window; "
                             f"got {chunk_samples}")
        self.cfg = cfg or StreamConfig()
        self.model = model
        self.chunk = chunk_samples
        self.n_new = chunk_samples // HOP
        self.n_labels = int(model.output.out_features)
        self.device = _device(model)
        self._model = model
        if variables is None:
            with torch.no_grad():
                self._packed = model.eval_operands()
        else:
            self.set_variables(variables)

    def set_variables(self, variables) -> None:
        """Swap the weights for the following steps (a state dict in the
        port's names), loaded into the streamer's own copy of the model."""
        with torch.no_grad():
            if self._model is self.model:
                self._model = copy.deepcopy(self.model).eval()
            load_state_dict(self._model, variables)
            self._packed = self._model.eval_operands()

    def reset(self) -> StreamState:
        z = dict(dtype=torch.float32, device=self.device)
        return StreamState(
            sample_tail=torch.zeros((NFFT,), **z),
            feat_ring=torch.zeros((WINDOW_FRAMES, F.N_DCT), **z),
            post_ring=torch.zeros((self.cfg.smoothing_window, self.n_labels), **z),
            frames_seen=torch.zeros((), dtype=torch.int32, device=self.device),
            windows_seen=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _to_device(self, chunks) -> torch.Tensor:
        x = torch.as_tensor(chunks)
        if x.dtype != torch.int16:
            x = x.to(torch.float32)
        return x.to(self.device)

    def _step(self, state: StreamState, chunks: torch.Tensor) -> tuple[StreamState, torch.Tensor]:
        """One step of N streams: state leaves and chunks with a leading stream axis."""
        if chunks.dtype == torch.int16:
            chunks = chunks.to(torch.float32) * (1.0 / 32768.0)  # exact: a power of two
        # [tail | chunk]; the new frames start inside the tail, so each has its
        # full 480 samples of left context (causal: no center padding online).
        buf = torch.cat([state.sample_tail, chunks], dim=1)
        new_feats = mfcc(buf, center=False, n_frames=self.n_new)  # (N, n_new, 40)
        feat_ring = torch.cat([state.feat_ring[:, self.n_new:], new_feats], dim=1)  # roll by -n_new, set
        post = torch.softmax(self._model(feat_ring, packed=self._packed), dim=-1)
        post_ring = torch.cat([state.post_ring[:, 1:], post[:, None]], dim=1)  # roll by -1, set
        windows_seen = state.windows_seen + 1
        # Mean over the filled part of the ring.
        w = self.cfg.smoothing_window
        have = torch.clamp(windows_seen, max=w)
        mask = torch.arange(w, device=buf.device) >= (w - have)[:, None]
        smoothed = torch.where(mask[..., None], post_ring, 0.0).sum(dim=1) / have.to(torch.float32)[:, None]
        new_state = StreamState(
            sample_tail=buf[:, -NFFT:].clone(),
            feat_ring=feat_ring,
            post_ring=post_ring,
            frames_seen=state.frames_seen + self.n_new,
            windows_seen=windows_seen,
        )
        return new_state, smoothed

    def process(self, state: StreamState, chunk) -> tuple[StreamState, torch.Tensor]:
        """Feed one chunk; returns (state, smoothed posterior (n_labels,)) on the device."""
        if tuple(chunk.shape) != (self.chunk,):
            raise ValueError(f"chunk must be ({self.chunk},), got {tuple(chunk.shape)}")
        with torch.no_grad():
            batched = StreamState(*(x[None] for x in state))
            new, smoothed = self._step(batched, self._to_device(chunk)[None])
        return StreamState(*(x[0] for x in new)), smoothed[0]


class BatchStreamer:
    """N concurrent online streams advanced by one step over a leading stream axis.

    The classifier sees a ``(N, 101, 40)`` batch. Semantics are exactly N
    independent ``Streamer``s: BN is frozen at inference and the model is
    per-example, so streams never interact.

    With ``data_axis``, this rank holds only its rows ``rows`` of the stream
    axis (``reset`` gives those) and ``process`` is collective: every rank
    passes the full chunks and mask and gets the full posteriors back.
    ``set_variables`` is called on every rank, with the same weights.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        variables,
        n_streams: int,
        cfg: StreamConfig | None = None,
        chunk_samples: int = 3200,
        data_axis: str | None = None,
    ):
        self._single = Streamer(model, variables, cfg, chunk_samples)
        self.cfg = self._single.cfg
        self.n_streams = n_streams
        self._mesh = make_data_mesh(0, data_axis) if data_axis is not None else None
        self.rows = self._mesh.shard_rows(n_streams) if self._mesh is not None else (0, n_streams)
        self.chunk = chunk_samples
        self.n_labels = self._single.n_labels
        self.device = self._single.device

    def set_variables(self, variables) -> None:
        """Swap the weights for the following steps (see ``Streamer.set_variables``)."""
        self._single.set_variables(variables)

    def reset(self) -> StreamState:
        """Zero state for this rank's streams (all of them without ``data_axis``)."""
        single = self._single.reset()
        n = self.rows[1] - self.rows[0]
        return StreamState(*(torch.zeros((n,) + x.shape, dtype=x.dtype, device=x.device) for x in single))

    def process(
        self,
        state: StreamState,
        chunks,
        mask: np.ndarray | None = None,
    ) -> tuple[StreamState, torch.Tensor]:
        """Feed one chunk per stream; returns (state, smoothed (N, n_labels)) on the device.

        ``mask`` (N,) bool selects which streams advance; None = all. Masked
        streams keep their state bit for bit and their posterior row is zeros.
        With ``data_axis``: ``state`` is this rank's rows, ``chunks`` and
        ``mask`` are every stream's, and the posteriors come back for all N.
        """
        if tuple(chunks.shape) != (self.n_streams, self.chunk):
            raise ValueError(f"chunks must be ({self.n_streams}, {self.chunk}), got {tuple(chunks.shape)}")
        start, stop = self.rows
        with torch.no_grad():
            new, smoothed = self._single._step(state, self._single._to_device(chunks[start:stop]))
            if mask is not None:
                m = torch.as_tensor(np.asarray(mask, bool)[start:stop]).to(self.device)
                sel = lambda n, o: torch.where(m.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)  # noqa: E731
                new, smoothed = StreamState(*(sel(n, o) for n, o in zip(new, state))), torch.where(
                    m[:, None], smoothed, 0.0)
            if self._mesh is not None:
                smoothed = self._mesh.all_gather_rows(smoothed, self.n_streams)
            return new, smoothed
