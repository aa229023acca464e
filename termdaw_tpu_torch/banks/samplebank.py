"""Carried over from termdaw_tpu/banks/samplebank.py so that import
resampling runs the port's numpy `resample_sample`; only the imports
differ.

Sample (stereo audio buffer) + SampleBank.

Mirrors the reference's `Sample`/`SampleBank` (sample.rs:24-349):

* planar stereo float32 buffers,
* load methods stereo/left/right/loudest/normalize-seperate/mix-down
  (sample.rs:196-210),
* int WAV samples read as raw counts then peak-normalized (the reference
  comments out the int->float scale divide and relies on normalization,
  sample.rs:268-274 + 297-303),
* odd interleaved tails pushed to L (sample.rs:283-292),
* automatic windowed-sinc resample to the project rate on import
  (sample.rs:305-310), on the host (ops/resample.resample_sample),
* mark-dead + compacting refresh for hot reload (sample.rs:316-336),
* max input samplerate/bitdepth tracking for render warnings
  (sample.rs:252-255, 346-348).

Deviation (documented): peak-normalizing a fully-silent sample is a no-op
here; the reference would divide by zero (sample.rs:125-130).
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from ..fileio.wav import read_wav, WavError
from ..utils.term import YELLOW, BLUE, DEFAULT


class SampleLoadMethod(Enum):
    STEREO = "stereo"
    LEFT = "left"
    RIGHT = "right"
    LOUDEST = "loudest"
    NORM = "normalize-seperate"
    MIX = "mix-down"

    @staticmethod
    def from_str(s: str) -> "SampleLoadMethod":
        # any unknown string falls back to stereo (reference sample.rs:199-209)
        return {
            "left": SampleLoadMethod.LEFT,
            "right": SampleLoadMethod.RIGHT,
            "loudest": SampleLoadMethod.LOUDEST,
            "normalize-seperate": SampleLoadMethod.NORM,
            "mix-down": SampleLoadMethod.MIX,
        }.get(s, SampleLoadMethod.STEREO)


def _absmax(x: np.ndarray) -> float:
    return float(np.max(np.abs(x))) if x.size else 0.0


def _mean_energy(x: np.ndarray) -> float:
    return float(np.mean(np.abs(x))) if x.size else 0.0


class Sample:
    """Planar stereo float32 buffer (reference sample.rs:24-185)."""

    __slots__ = ("l", "r")

    def __init__(self, l: np.ndarray, r: np.ndarray) -> None:
        self.l = np.asarray(l, dtype=np.float32)
        self.r = np.asarray(r, dtype=np.float32)

    @staticmethod
    def zeros(n: int) -> "Sample":
        return Sample(np.zeros(n, np.float32), np.zeros(n, np.float32))

    @staticmethod
    def build(l: np.ndarray, r: np.ndarray, method: SampleLoadMethod) -> "Sample":
        """Combine raw channels per load method (reference sample.rs:38-77)."""
        l = np.asarray(l, dtype=np.float32)
        r = np.asarray(r, dtype=np.float32)
        if method == SampleLoadMethod.LEFT:
            if l.size == 0:
                raise ValueError("Sample.build: l has length 0.")
            return Sample(l, l.copy())
        if method == SampleLoadMethod.RIGHT:
            if r.size == 0:
                raise ValueError("Sample.build: r has length 0.")
            return Sample(r.copy(), r)
        if method == SampleLoadMethod.LOUDEST:
            if _mean_energy(l) > _mean_energy(r):
                return Sample(l, l.copy())
            return Sample(r.copy(), r)
        if l.size != r.size:
            raise ValueError(
                f"Sample.build: l and r do not have the same length: "
                f"{l.size} and {r.size}."
            )
        if l.size == 0:
            raise ValueError("Sample.build: l and r have length 0.")
        return Sample(l, r)

    def __len__(self) -> int:
        return int(self.l.shape[0])

    def scan_max(self) -> float:
        return max(_absmax(self.l), _absmax(self.r))

    def scale(self, scalar: float) -> None:
        self.l *= np.float32(scalar)
        self.r *= np.float32(scalar)

    def normalize(self) -> None:
        """Peak-normalize both channels together (reference sample.rs:125-130)."""
        m = self.scan_max()
        if m > 0.0:
            self.scale(1.0 / m)

    def normalize_seperate(self) -> None:
        """Per-channel peak normalize (reference sample.rs:132-137;
        the reference's spelling is kept for API parity)."""
        ml, mr = _absmax(self.l), _absmax(self.r)
        if ml > 0.0:
            self.l *= np.float32(1.0 / ml)
        if mr > 0.0:
            self.r *= np.float32(1.0 / mr)

    def mix_down(self) -> None:
        """Sum channels, renormalize, copy to both (reference sample.rs:139-147)."""
        mix = self.l + self.r
        m = _absmax(mix)
        if m > 0.0:
            mix *= np.float32(1.0 / m)
        self.l = mix.copy()
        self.r = mix

    def interleave(self) -> np.ndarray:
        out = np.empty(2 * len(self), dtype=np.float32)
        out[0::2] = self.l
        out[1::2] = self.r
        return out

    def as_array(self) -> np.ndarray:
        """[frames, 2] view for the compiled graph."""
        return np.stack([self.l, self.r], axis=1)

    def resample(self, from_sr: int, to_sr: int) -> "Sample":
        """Windowed-sinc resample on the host (reference uses rubato
        SincFixedIn, sample.rs:150-175)."""
        from ..ops.resample import resample_sample

        out = resample_sample(self.as_array(), from_sr, to_sr)
        out = np.asarray(out)
        return Sample(out[:, 0].copy(), out[:, 1].copy())


class SampleBank:
    def __init__(self, sample_rate: int) -> None:
        self.sample_rate = sample_rate
        self.samples: list[Sample] = []
        self.names: dict[str, int] = {}
        self.max_sr = 0
        self.max_bd = 0
        self.marked: set[int] = set()

    def add(self, name: str, file: str, method: SampleLoadMethod) -> None:
        """Load, combine, normalize, and resample a WAV into the bank
        (reference sample.rs:224-314). Raises ValueError with a
        reference-style message on failure."""
        if name in self.names:
            raise ValueError(
                f'SampleBank: there is already a sample with name "{name}" present.'
            )
        try:
            data, spec = read_wav(file, scale=False)
        except (WavError, OSError):
            raise ValueError(
                f'SampleBank: could not open file "{file}".'
            ) from None
        if method == SampleLoadMethod.STEREO and spec.channels != 2:
            raise ValueError(
                "SampleBank: only 2 channel samples are supported for stereo "
                f"samples, found {spec.channels} channels."
            )
        if method != SampleLoadMethod.STEREO and spec.channels > 2:
            raise ValueError(
                "SampleBank: only 1,2 channel samples are supported for left "
                f"or right samples, found {spec.channels} channels."
            )
        sr = spec.sample_rate
        bd = spec.bits_per_sample
        self.max_sr = max(self.max_sr, sr)
        self.max_bd = max(self.max_bd, bd)
        if sr > self.sample_rate:
            print(
                f'{YELLOW}TermDaw: warning: sample {BLUE}"{name}"{YELLOW} has '
                f"a higher samplerate({BLUE}{sr}{YELLOW}) than the "
                f"project({BLUE}{self.sample_rate}{YELLOW}).{DEFAULT}"
            )
        if spec.channels == 1:
            flat = data[:, 0]
            if method == SampleLoadMethod.LEFT:
                l, r = flat, np.zeros(0, np.float32)
            else:
                l, r = np.zeros(0, np.float32), flat
        else:
            # first two channels, interleaved pairs; odd tail goes to L
            # (reference sample.rs:283-292)
            flat = data[:, :2]
            l = flat[:, 0].copy()
            r = flat[:, 1].copy()
        sample = Sample.build(l, r, method)
        if method == SampleLoadMethod.NORM:
            sample.normalize_seperate()
        elif method == SampleLoadMethod.MIX:
            sample.mix_down()
        else:
            sample.normalize()
        if sr != self.sample_rate:
            sample = sample.resample(sr, self.sample_rate)
        self.samples.append(sample)
        self.names[name] = len(self.samples) - 1

    def mark_dead(self, name: str) -> None:
        idx = self.names.get(name)
        if idx is not None:
            self.marked.add(idx)

    def refresh(self) -> None:
        """Compact away marked samples (reference sample.rs:322-336)."""
        if not self.marked:
            return
        new_map: dict[str, int] = {}
        new_vec: list[Sample] = []
        for name, index in self.names.items():
            if index in self.marked:
                continue
            new_vec.append(self.samples[index])
            new_map[name] = len(new_vec) - 1
        self.names = new_map
        self.samples = new_vec
        self.marked.clear()

    def get_index(self, name: str) -> int | None:
        return self.names.get(name)

    def get_sample(self, index: int) -> Sample:
        return self.samples[index]

    def get_max_sr_bd(self) -> tuple[int, int]:
        return self.max_sr, self.max_bd
