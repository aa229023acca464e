"""The checks that decide `correct`: what the window produced against
the plain reference, each number with its limit."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import files, precision, render


def wav_vs(got_ints: np.ndarray, want: np.ndarray, bd: int) -> dict:
    """Numbers of a bounce's integer samples against the reference's
    unrounded ones (both [frames, 2] at the WAV's scale; the reference's
    length is the song's, from the spec alone): frames_off, the frames
    missing or extra; max_err_fs, the widest gap over the frames both
    hold, as a share of full scale."""
    amp = render.amplitude(bd)
    frames_off = abs(len(got_ints) - len(want))
    n = min(len(got_ints), len(want))
    # the quantize saturates: a resampled peak that rings past full
    # scale is written at the rail
    want = np.clip(want[:n], -(2.0 ** (bd - 1)), _hi(bd))
    err = np.abs(got_ints[:n].astype(np.float64) - want) / amp
    return {"frames_off": float(frames_off),
            "max_err_fs": float(err.max()) if n else float("inf")}


def _hi(bd: int) -> float:
    """The largest integer the quantize writes (for 32 bits the largest
    float32 below 2^31)."""
    return 2.0 ** (bd - 1) - 1 if bd < 32 else 2147483520.0


def checked(values: dict, limits: dict) -> dict:
    return {k: {"value": float(values[k]), "limit": float(limits[k])}
            for k in limits}


def bounce(spec: dict, d: Path, wav: Path, renders: int) -> dict:
    """The WAV of a State's render number `renders` against the
    reference. From the third render on, every render of a project starts
    from the same state (the voices and effect tails the song's end
    leaves; the Normalize's peak no longer grows), so three passes stand
    for any later one."""
    ints, rate, bits = files.read_wav_ints(wav)
    want = render.bounce(spec, d, passes=min(renders, 3))
    assert len(want) == render.song_frames(spec)
    vals = wav_vs(ints, want, int(spec["bd"]))
    if rate != int(spec["render_sr"]) or bits != int(spec["bd"]):
        vals["frames_off"] = float("inf")
    return vals


def quantize(x: np.ndarray, bd: int) -> np.ndarray:
    """Reference samples at the WAV's scale to its integers: clipped,
    truncated toward zero."""
    return np.trunc(np.clip(x, -(2.0 ** (bd - 1)), _hi(bd))).astype(np.int64)


def bounce_control(spec: dict, d: Path) -> dict:
    """The numbers of the control: the reference's own bounce computed in
    bfloat16 (every vertex's output and the render's output rounded),
    put in the program's place."""
    want = render.bounce(spec, d)
    low = render.bounce(spec, d, cast=precision.bf16)
    return wav_vs(quantize(low, int(spec["bd"])), want, int(spec["bd"]))


def played(spec: dict, d: Path, heard: np.ndarray, frames: int,
           prebuffer_frames: int = 0) -> dict:
    """What a Player queued from a fresh start of `spec` (float32 frames
    at the project rate, [frames, 2]) against the reference: frames_off,
    the frames short of the `frames` the traffic asks for; the widest gap
    over all of it and over its first `prebuffer_frames`, as shares of
    full scale."""
    bl = int(spec["bl"])
    blocks = -(-max(frames, len(heard)) // bl)
    want = render.render_passes(spec, d, 1, blocks=blocks)
    n = min(len(heard), len(want))
    err = np.abs(heard[:n].astype(np.float64) - want[:n]).max(axis=1)
    vals = {"frames_off": float(max(0, frames - len(heard))),
            "played_max_err": float(err.max()) if n else float("inf")}
    if prebuffer_frames:
        vals["prebuffer_max_err"] = (float(err[:prebuffer_frames].max())
                                     if n else float("inf"))
    return vals


def played_control(spec: dict, d: Path, blocks: int) -> float:
    """The control of `played`: the widest gap of the reference computed
    in bfloat16, put in the Player's place."""
    want = render.render_passes(spec, d, 1, blocks=blocks)
    low = render.render_passes(spec, d, 1, blocks=blocks,
                               cast=precision.bf16)
    return float(np.abs(low - want).max())
