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
Not ported yet: local conditioning's sidecars (LC training, ROADMAP.md
queue 1, item 2, step 2b).
"""

from __future__ import annotations

import fnmatch
import os
import queue
import random
import re
import threading
import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from wavenet_torch.audio import read_wav, trim_silence

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


class AudioReader:
    """Background-threaded chunk loader.

    Batches come from :meth:`dequeue` (float32 audio
    ``[batch, receptive_field + sample_size]``) and :meth:`dequeue_gc`
    (int32 speaker ids ``[batch]`` of the last dequeued batch).
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
                 lc_enabled: bool = False):
        if lc_enabled:
            raise NotImplementedError(
                "the reader's local conditioning sidecars are not ported "
                "yet (LC training: ROADMAP.md queue 1, item 2, step 2b)")
        self.audio_dir = audio_dir
        self.sample_rate = sample_rate
        self.gc_enabled = gc_enabled
        self.receptive_field = receptive_field
        self.sample_size = sample_size
        self.silence_threshold = silence_threshold
        self.bucket_size = bucket_size
        self.use_native = use_native
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

    def _thread_main(self, thread_index: int) -> None:
        """Trim, pad, chunk, enqueue."""
        rng = random.Random(None if self._seed is None
                            else self._seed + thread_index)
        for audio, filename, category_id in load_generic_audio(
                self.audio_dir, self.sample_rate, rng, self.use_native):
            if self._stop.is_set():
                return
            if self.silence_threshold is not None:
                audio = self._trim(audio[:, 0]).reshape(-1, 1)
                if audio.size == 0:
                    warnings.warn(
                        f"Warning: {filename} was ignored as it contains "
                        "only silence. Consider decreasing "
                        "trim_silence threshold, or adjust volume of the "
                        "audio.")
                    continue
            audio = np.pad(audio, [[self.receptive_field, 0], [0, 0]],
                           mode="constant")
            if self.sample_size:
                # Overlapping chunks: advance by sample_size, keep the
                # trailing receptive_field as context for the next chunk.
                width = self.receptive_field + self.sample_size
                while len(audio) > self.receptive_field:
                    piece = audio[:width]
                    if len(piece) < width:
                        piece = np.pad(piece, [[0, width - len(piece)],
                                               [0, 0]], mode="constant")
                    self._put((piece[:, 0].astype(np.float32), category_id))
                    audio = audio[self.sample_size:]
            else:
                n = len(audio)
                piece = np.pad(audio, [[0, self._bucket_length(n) - n],
                                       [0, 0]], mode="constant")
                self._put((piece[:, 0].astype(np.float32), category_id))

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
            t = threading.Thread(target=self._thread_main, args=(i,),
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
        self._last_ids = np.asarray(
            [0 if b[1] is None else b[1] for b in batch], dtype=np.int32)
        if self.sample_size is None and num_elements > 1:
            width = max(len(b[0]) for b in batch)
            batch = [(np.pad(a, (0, width - len(a))), cid)
                     for a, cid in batch]
        return np.stack([b[0] for b in batch])

    def dequeue_gc(self, num_elements: int) -> np.ndarray:
        """Speaker ids of the batch returned by the last dequeue()."""
        if not hasattr(self, "_last_ids"):
            raise RuntimeError("dequeue_gc() must follow dequeue().")
        if len(self._last_ids) != num_elements:
            raise ValueError(f"the last batch had {len(self._last_ids)} "
                             f"elements, not {num_elements}")
        return self._last_ids

    def __enter__(self):
        self.start_threads()
        return self

    def __exit__(self, *exc):
        self.stop_threads()
