"""Host-threaded audio data pipeline.

Counterpart of ``wavenet_tpu/data/reader.py``, with the same data
semantics:

* corpus walk and the VCTK speaker-id pattern (``p<speaker>_<utt>.wav``),
* file order sampled WITH replacement (the reference's quirk),
* wav decode, polyphase resample and RMS silence trim through the
  native C++ library (``data/native.py``) by default, as the JAX reader
  does, and through scipy (``wavenet_torch.audio``) with
  ``use_native=False`` or where the library cannot be built or loaded,
* left zero-padding by receptive_field, then chunks of
  ``receptive_field + sample_size`` samples that overlap by
  receptive_field,
* worker threads and a bounded queue; batches come out as numpy arrays.

Whole-utterance mode (``sample_size=None``) pads each utterance to a
geometric bucket ladder (bucket_size * 2^k), as the JAX package does.

Local conditioning: each ``<stem>.wav`` has a ``<stem>.lc.npy`` sidecar of
frames ``[F, lc_channels]``, one frame per ``lc_hop`` output samples. The
host mode upsamples it and trims, pads and chunks it in lockstep with the
audio; the device mode ships each chunk's frame window and alignment
(``lc.LCFrameChunk``), which the train step upsamples on the card.
"""

from __future__ import annotations

import fnmatch
import os
import queue
import random
import re
import threading
import warnings
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from wavenet_torch.audio import read_wav, trim_silence, trim_silence_indices
from wavenet_torch.lc import (LCFrameChunk, fit_lc_to_length,
                              frame_window_size, load_lc_sidecar,
                              upsample_lc)

FILE_PATTERN = r"p([0-9]+)_([0-9]+)\.wav"


def get_category_cardinality(files: List[str]
                             ) -> Tuple[Optional[int], Optional[int]]:
    """(min_id, max_id) over speaker ids parsed from filenames."""
    id_reg_expression = re.compile(FILE_PATTERN)
    min_id, max_id = None, None
    for filename in files:
        matches = id_reg_expression.findall(filename)
        if not matches:
            continue
        pid = int(matches[0][0])
        if min_id is None or pid < min_id:
            min_id = pid
        if max_id is None or pid > max_id:
            max_id = pid
    return min_id, max_id


def find_files(directory: str, pattern: str = "*.wav") -> List[str]:
    files = []
    for root, _, filenames in os.walk(directory):
        for filename in fnmatch.filter(filenames, pattern):
            files.append(os.path.join(root, filename))
    return sorted(files)


def randomize_files(files: List[str],
                    rng: Optional[random.Random] = None) -> Iterator[str]:
    """Yield files sampled WITH replacement, forever."""
    rng = rng or random
    n = len(files)
    while True:
        yield files[rng.randint(0, n - 1)]


def parse_speaker_id(filename: str) -> Optional[int]:
    matches = re.compile(FILE_PATTERN).findall(filename)
    if not matches:
        return None
    return int(matches[0][0])


def not_all_have_id(files: List[str]) -> bool:
    return any(parse_speaker_id(os.path.basename(f)) is None for f in files)


def _read_wav_any(filename: str, sample_rate: int,
                  use_native: bool = True) -> np.ndarray:
    """Decode+resample via the native C++ library, scipy as fallback."""
    if use_native:
        from wavenet_torch.data import native
        loaded = native.read_wav(filename, sample_rate)
        if loaded is not None:
            return loaded[0]
    audio, _ = read_wav(filename, sample_rate)
    return audio


def load_generic_audio(directory: str, sample_rate: int,
                       rng: Optional[random.Random] = None,
                       use_native: bool = True):
    """Generator of (audio [T, 1] float32, filename, speaker_id)."""
    files = find_files(directory)
    if not files:
        raise ValueError(f"No wav files found in '{directory}'.")
    for filename in randomize_files(files, rng):
        audio = _read_wav_any(filename, sample_rate, use_native)
        category_id = parse_speaker_id(os.path.basename(filename))
        yield audio.reshape(-1, 1), filename, category_id


class _WorkerError(NamedTuple):
    error: Exception


class AudioReader:
    """Background-threaded chunk loader.

    Batches come from :meth:`dequeue` (float32 audio
    ``[batch, receptive_field + sample_size]``), :meth:`dequeue_gc`
    (int32 speaker ids ``[batch]`` of the last dequeued batch) and, with
    local conditioning, :meth:`dequeue_lc` (its conditioning).
    """

    def __init__(self,
                 audio_dir: str,
                 sample_rate: int,
                 gc_enabled: bool = False,
                 receptive_field: int = 1024,
                 sample_size: Optional[int] = None,
                 silence_threshold: Optional[float] = None,
                 queue_size: int = 32,
                 num_threads: int = 1,
                 seed: Optional[int] = None,
                 bucket_size: int = 16000,
                 use_native: bool = True,
                 lc_enabled: bool = False,
                 lc_channels: Optional[int] = None,
                 lc_hop: Optional[int] = None,
                 lc_upsample: str = "repeat",
                 lc_device_upsample: bool = False):
        """``lc_*``: local conditioning from ``<stem>.lc.npy`` sidecars
        ``[frames, lc_channels]``; ``lc_hop`` is the output samples (at
        ``sample_rate``, after resampling) a frame covers, ``lc_upsample``
        the mapping to sample rate. ``lc_device_upsample`` ships frame
        windows (``LCFrameChunk``) instead of the upsampled stream."""
        if lc_enabled and (lc_channels is None or lc_hop is None):
            raise ValueError("lc_enabled requires lc_channels and lc_hop")
        self.audio_dir = audio_dir
        self.sample_rate = sample_rate
        self.gc_enabled = gc_enabled
        self.receptive_field = receptive_field
        self.sample_size = sample_size
        self.silence_threshold = silence_threshold
        self.bucket_size = bucket_size
        self.use_native = use_native
        self.lc_enabled = lc_enabled
        self.lc_channels = lc_channels
        self.lc_hop = lc_hop
        self.lc_upsample = lc_upsample
        self.lc_device_upsample = lc_device_upsample
        self._seen_buckets: set = set()
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._num_threads = num_threads
        self._seed = seed

        files = find_files(audio_dir)
        if not files:
            raise ValueError(f"No audio files found in '{audio_dir}'.")
        print(f"files length: {len(files)}")
        self.gc_category_cardinality = None
        if gc_enabled:
            if not_all_have_id(files):
                raise ValueError(
                    "Global conditioning is enabled, but not all files "
                    "conform to the pattern having a speaker id.")
            _, max_id = get_category_cardinality(files)
            # +1 so the embedding table covers ids 0..max (ids need not
            # be dense).
            self.gc_category_cardinality = max_id + 1
            print(f"Detected --gc_cardinality={self.gc_category_cardinality}")

    # -- worker ------------------------------------------------------------

    def _load_lc_frames(self, filename: str) -> np.ndarray:
        """The checked sidecar frames [F, C] of one decoded file."""
        feats = load_lc_sidecar(filename)
        if feats is None:
            raise ValueError(
                f"Local conditioning is enabled but '{filename}' has no "
                "<stem>.lc.npy sidecar.")
        if feats.shape[1] != self.lc_channels:
            raise ValueError(
                f"'{filename}' sidecar has {feats.shape[1]} channels, "
                f"expected lc_channels={self.lc_channels}")
        return feats

    def _load_lc(self, filename: str, n_samples: int) -> np.ndarray:
        """Upsampled conditioning [n_samples, C] of one decoded file."""
        lc = upsample_lc(self._load_lc_frames(filename), self.lc_hop,
                         self.lc_upsample)
        return fit_lc_to_length(lc, n_samples)

    def _lc_window(self, feats: np.ndarray, orig_start: int, width: int,
                   n_valid: int, zero_before: int) -> tuple:
        """One chunk's ``LCFrameChunk`` fields: (frame window [Fw, C],
        orig_start, f0, f_valid, n_valid, zero_before)."""
        Fw = frame_window_size(width, self.lc_hop)
        f0 = max(0, orig_start // self.lc_hop - 1)
        win = feats[f0:f0 + Fw]
        if win.shape[0] < Fw:
            win = np.pad(win, [[0, Fw - win.shape[0]], [0, 0]])
        return (np.ascontiguousarray(win, np.float32), np.int32(orig_start),
                np.int32(f0), np.int32(feats.shape[0]), np.int32(n_valid),
                np.int32(zero_before))

    def _worker(self, thread_index: int) -> None:
        """``_thread_main``; an error (a missing or mismatched sidecar, an
        unreadable file) goes into the queue and is raised by the dequeue
        that takes it, instead of leaving the dequeue waiting forever."""
        try:
            self._thread_main(thread_index)
        except Exception as e:  # noqa: BLE001 - raised by dequeue()
            self._put(_WorkerError(e))

    def _thread_main(self, thread_index: int) -> None:
        """Trim, pad, chunk, enqueue. A conditioning stream is trimmed,
        padded and chunked in lockstep with the audio (the same trim
        indices, receptive-field pad and overlapping windows); a frame
        window records where its chunk lies instead."""
        rng = random.Random(None if self._seed is None
                            else self._seed + thread_index)
        for audio, filename, category_id in load_generic_audio(
                self.audio_dir, self.sample_rate, rng, self.use_native):
            if self._stop.is_set():
                return
            lc = frames = None
            trim_start = 0
            if self.lc_enabled and self.lc_device_upsample:
                frames = self._load_lc_frames(filename)
            elif self.lc_enabled:
                lc = self._load_lc(filename, len(audio))
            if self.silence_threshold is not None:
                if self.lc_enabled:
                    # The native trimmer returns only the kept signal; the
                    # index form computes the same energies.
                    start, end = trim_silence_indices(
                        audio[:, 0], self.silence_threshold)
                    audio = audio[start:end]
                    trim_start = start
                    if lc is not None:
                        lc = lc[start:end]
                else:
                    audio = self._trim(audio[:, 0]).reshape(-1, 1)
                if audio.size == 0:
                    warnings.warn(
                        f"Warning: {filename} was ignored as it contains "
                        "only silence. Consider decreasing "
                        "trim_silence threshold, or adjust volume of the "
                        "audio.")
                    continue
            # The receptive field of zeros before the first sample; the
            # conditioning stream gets zeros there too.
            rf = self.receptive_field
            audio = np.pad(audio, [[rf, 0], [0, 0]], mode="constant")
            if lc is not None:
                lc = np.pad(lc, [[rf, 0], [0, 0]], mode="constant")
            if self.sample_size:
                # Overlapping chunks: advance by sample_size, keep the
                # trailing receptive_field as context for the next chunk.
                width = rf + self.sample_size
                k = 0
                while len(audio) > rf:
                    piece = audio[:width]
                    n_valid = len(piece)
                    lc_piece = None
                    if lc is not None:
                        lc_piece = np.pad(lc[:width],
                                          [[0, width - n_valid], [0, 0]])
                    elif frames is not None:
                        # Chunk position t lies at original sample
                        # trim_start + k * sample_size + t - rf.
                        lc_piece = self._lc_window(
                            frames, trim_start + k * self.sample_size - rf,
                            width, n_valid, trim_start)
                    if n_valid < width:
                        piece = np.pad(piece, [[0, width - n_valid],
                                               [0, 0]], mode="constant")
                    self._put((piece[:, 0].astype(np.float32), category_id,
                               lc_piece))
                    audio = audio[self.sample_size:]
                    if lc is not None:
                        lc = lc[self.sample_size:]
                    k += 1
            else:
                n = len(audio)
                bucketed = self._bucket_length(n)
                piece = np.pad(audio, [[0, bucketed - n], [0, 0]],
                               mode="constant")
                lc_piece = None
                if lc is not None:
                    lc_piece = np.pad(lc, [[0, bucketed - n], [0, 0]])
                elif frames is not None:
                    lc_piece = self._lc_window(frames, trim_start - rf,
                                               bucketed, n, trim_start)
                self._put((piece[:, 0].astype(np.float32), category_id,
                           lc_piece))

    def _trim(self, audio: np.ndarray) -> np.ndarray:
        if self.use_native:
            from wavenet_torch.data import native
            trimmed = native.trim_silence(audio, self.silence_threshold)
            if trimmed is not None:
                return trimmed
        return trim_silence(audio, self.silence_threshold)

    def _bucket_length(self, n: int) -> int:
        """Smallest bucket-ladder rung >= n (rungs: bucket_size * 2^k)."""
        rung = self.bucket_size
        while rung < n:
            rung *= 2
        if rung not in self._seen_buckets:
            self._seen_buckets.add(rung)
            print(f"whole-utterance bucket {rung} first used")
        return rung

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    # -- public API --------------------------------------------------------

    def start_threads(self) -> None:
        for i in range(self._num_threads):
            t = threading.Thread(target=self._worker, args=(i,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop_threads(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()

    def dequeue(self, num_elements: int) -> np.ndarray:
        """Audio batch [num_elements, rf + sample_size] float32 (in
        whole-utterance mode, zero-padded to the longest in the batch)."""
        batch = [self._queue.get() for _ in range(num_elements)]
        for item in batch:
            if isinstance(item, _WorkerError):
                raise item.error
        self._last_ids = np.asarray(
            [0 if b[1] is None else b[1] for b in batch], dtype=np.int32)
        if self.sample_size is None and num_elements > 1:
            width = max(len(b[0]) for b in batch)
            batch = [(np.pad(a, (0, width - len(a))), cid,
                      self._fit_lc(lc, width)) for a, cid, lc in batch]
        if not self.lc_enabled:
            self._last_lc = None
        elif self.lc_device_upsample:
            self._last_lc = LCFrameChunk(*(
                np.stack([b[2][i] for b in batch]) for i in range(6)))
        else:
            self._last_lc = np.stack([b[2] for b in batch])
        return np.stack([b[0] for b in batch])

    def _fit_lc(self, lc, width: int):
        """A whole utterance's conditioning, grown to the batch's width: a
        stream with zeros, a frame window with zero rows (the upsample
        never reads them: it clips to f_valid)."""
        if lc is None:
            return None
        if isinstance(lc, tuple):
            Fw = frame_window_size(width, self.lc_hop)
            return (np.pad(lc[0], [[0, Fw - lc[0].shape[0]], [0, 0]]),
                    ) + lc[1:]
        return np.pad(lc, [(0, width - len(lc)), (0, 0)])

    def dequeue_gc(self, num_elements: int) -> np.ndarray:
        """Speaker ids of the batch returned by the last dequeue()."""
        if not hasattr(self, "_last_ids"):
            raise RuntimeError("dequeue_gc() must follow dequeue().")
        if len(self._last_ids) != num_elements:
            raise ValueError(f"the last batch had {len(self._last_ids)} "
                             f"elements, not {num_elements}")
        return self._last_ids

    def dequeue_lc(self, num_elements: int):
        """Conditioning of the batch returned by the last dequeue(): the
        stream [batch, width, lc_channels] float32, or in the device mode
        an ``LCFrameChunk`` of numpy arrays."""
        if getattr(self, "_last_lc", None) is None:
            raise RuntimeError("dequeue_lc() must follow dequeue() on an "
                               "lc_enabled reader.")
        n = (self._last_lc.frames.shape[0]
             if isinstance(self._last_lc, LCFrameChunk)
             else len(self._last_lc))
        if n != num_elements:
            raise ValueError(f"the last batch had {n} elements, not "
                             f"{num_elements}")
        return self._last_lc

    def __enter__(self):
        self.start_threads()
        return self

    def __exit__(self, *exc):
        self.stop_threads()
