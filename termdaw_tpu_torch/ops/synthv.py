"""Synth-family window kernels: DebugSine, Synth (3-osc), SampSyn (wavetable).

Port of termdaw_tpu/ops/synthv.py. All consume note-instance tables baked
by graph/bake.py: `idx` [nb, P] maps each block's slots to table rows
(-1 = empty slot, masked; its gathers wrap to the last row as jnp's do).
The per-note envelope clocks the reference accumulates frame by frame
(extensions.rs:459-578) come from the bake's per-(block, instance)
accumulated-f32 tables plus the in-block offset `ib` = f32(i)/f32(sr);
DebugSine's and Synth's oscillator phase uses the reference's time =
global_frame / sr (extensions.rs:501-503). Both `time2d` and `ib` are slices of the host
time table (graph/compile.time_table, a correctly rounded f32 division),
never a division on the device.

SampSyn's wavetable phase is uint32 fixed point, phase = n * round(hz/sr *
2^32) mod 2^32; PyTorch has no uint32 arithmetic, so it runs in int64
masked with 0xFFFFFFFF (the low 32 bits of the wrapped 64-bit product are
the uint32 product) and becomes float32 only after the mask.

On CUDA tensors `synth` and `sampsyn` each run their whole arm as one
hand-written kernel (csrc/synth.cu, csrc/sampsyn.cu) or raise; on CPU
tensors they run `synth_plain` and `sampsyn_plain`, the same arithmetic
in PyTorch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import osc
from .adsr import AdsrConf, _f32, _seg_bounds, apply_ads, apply_r_rt
from ..graph.bake import SENTINEL
from ..utils.roofline import counted

_U32 = 0xFFFFFFFF

# launches of the CUDA kernels by synth and sampsyn (CPU calls do not
# count)
synth_launches = 0
sampsyn_launches = 0


def _slots(bake, nb: int, bl: int, frames: torch.Tensor):
    idx = bake["idx"].long()  # [nb, P]
    return idx, idx >= 0, frames.reshape(nb, bl)


def debug_sine(
    bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int, bl: int,
    time2d: torch.Tensor,
) -> torch.Tensor:
    """Pure per-note sines, no envelope (extensions.rs:423-457)."""
    idx, valid, f = _slots(bake, nb, bl, frames)
    vel = bake["vels"][idx]
    active = (
        valid[:, None, :]
        & (f[:, :, None] >= bake["starts"][idx][:, None, :])
        & (f[:, :, None] < bake["ends"][idx][:, None, :])
    )  # [nb, bl, P]
    hz = bake["hz"][idx]  # [nb, P] host-exact (bake._note_hz)
    sig = osc.sin_f32(time2d[:, :, None] * hz[:, None, :] * osc.TWO_PI)
    sig = sig * torch.where(active, vel[:, None, :], 0.0)
    mono = torch.sum(sig, dim=2).reshape(-1)
    return torch.stack([mono, mono], dim=1)


def _clock_fields(bake, idx: torch.Tensor, ib: torch.Tensor):
    """Per-frame envelope clocks f32(env_t + i/sr) (extensions.rs:501-506)
    from the baked per-(block, instance) clocks. Returns (env_ads_t,
    env_rel_t, rel_t) shaped [nb, bl, P] / [nb, 1, P]."""
    safe = torch.clamp(idx, min=0)
    ads0 = torch.gather(bake["env_ads0"], 1, safe)  # [nb, P]
    rel0 = torch.gather(bake["env_rel0"], 1, safe)
    rel_t = bake["rel_t"][idx][:, None, :]
    ibx = ib[None, :, None]
    return ads0[:, None, :] + ibx, rel0[:, None, :] + ibx, rel_t


def _note_envelope(conf: AdsrConf, f, off_f, env_ads_t, env_rel_t, rel_t):
    """apply_ads while held, apply_r_rt after note-off
    (extensions.rs:505-506). `held` is per frame: the off frame may be
    baked ahead, but the release starts when the timeline reaches it."""
    held = (off_f == SENTINEL) | (f < off_f)
    return torch.where(held, apply_ads(conf, env_ads_t),
                       apply_r_rt(conf, env_rel_t, rel_t))


def _note_fields(bake, nb: int, bl: int, frames: torch.Tensor,
                 ib: torch.Tensor):
    """The per-slot note fields both synths read, broadcast to
    [nb, bl|1, P], and the life span mask: a note exists from its on
    event until its removal frame (extensions.rs:482-485)."""
    idx, valid, f = _slots(bake, nb, bl, frames)
    fb = f[:, :, None]
    on_b = bake["on_f"][idx][:, None, :]
    off_b = bake["off_f"][idx][:, None, :]
    alive = (valid[:, None, :] & (fb >= on_b)
             & (fb < bake["dead_f"][idx][:, None, :]))
    clocks = _clock_fields(bake, idx, ib)
    vel = bake["vels"][idx][:, None, :]
    return idx, fb, on_b, off_b, alive, clocks, vel


def synth_plain(
    bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int, bl: int,
    sq_vol: float, sq_z: float, sq_conf: AdsrConf,
    tf_vol: float, tf_z: float, tf_conf: AdsrConf,
    tr_vol: float, tr_conf: AdsrConf,
    time2d: torch.Tensor, ib: torch.Tensor,
) -> torch.Tensor:
    """3-oscillator synth (extensions.rs:459-529): square-sine +
    topflat-sine + triangle, each with its own ADSR; output scaled by
    1 / sum(vol * adsr.max_vel()) (extensions.rs:465-468). Oscillators
    with volume <= 0 are left out."""
    amp_mult = sq_vol * sq_conf.max_vel() + tf_vol * tf_conf.max_vel() \
        + tr_vol * tr_conf.max_vel()
    amp_mult = 1.0 / amp_mult if amp_mult != 0.0 else 0.0

    idx, fb, _on_b, off_b, alive, (ads_t, rel_el, rel_t), velb = (
        _note_fields(bake, nb, bl, frames, ib)
    )
    time = time2d[:, :, None]
    hz = bake["hz"][idx][:, None, :]  # [nb, 1, P] host-exact

    s = torch.zeros(fb.shape[:2] + (idx.shape[1],), dtype=torch.float32,
                    device=fb.device)
    if sq_vol > 0.0:
        env = _note_envelope(sq_conf, fb, off_b, ads_t, rel_el, rel_t)
        s = s + osc.square_sine(time, hz, sq_z) * velb * env * sq_vol
    if tf_vol > 0.0:
        env = _note_envelope(tf_conf, fb, off_b, ads_t, rel_el, rel_t)
        s = s + osc.topflat_sine(time, hz, tf_z) * velb * env * tf_vol
    if tr_vol > 0.0:
        env = _note_envelope(tr_conf, fb, off_b, ads_t, rel_el, rel_t)
        s = s + osc.triangle(time, hz) * velb * env * tr_vol
    s = torch.where(alive, s * amp_mult, 0.0)
    mono = torch.sum(s, dim=2).reshape(-1)
    return torch.stack([mono, mono], dim=1)


def sampsyn_plain(
    bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int, bl: int,
    conf: AdsrConf,
    table_times: torch.Tensor,  # [K] f32, ascending
    table_waves: torch.Tensor,  # [K, W] f32
    ib: torch.Tensor,
) -> torch.Tensor:
    """Time-varying wavetable synth (reference SampSyn,
    extensions.rs:531-578): the Synth note lifecycle and ADSR; the
    oscillator is a table lookup at fixed-point phase, its snapshots
    blended by note age (the reference passes env_time + rel_t as the
    table clock, extensions.rs:569)."""
    amp_mult = 1.0 / conf.max_vel() if conf.max_vel() != 0.0 else 0.0
    K, W = table_waves.shape

    idx, fb, on_b, off_b, alive, (ads_t, rel_el, rel_t), velb = (
        _note_fields(bake, nb, bl, frames, ib)
    )
    env = _note_envelope(conf, fb, off_b, ads_t, rel_el, rel_t)

    # table clock env_time + rel_t: ~time since note-on (rel_t 0 while held)
    held = (off_b == SENTINEL) | (fb < off_b)
    tau = torch.where(held, ads_t, rel_el + rel_t).reshape(-1)  # f32
    if K > 1:
        k = torch.clamp(
            torch.searchsorted(table_times, tau, right=True) - 1, 0, K - 2
        )
        t_k = table_times[k]
        t_k1 = table_times[k + 1]
        blend = torch.clamp(
            (tau - t_k) / torch.clamp(t_k1 - t_k, min=1e-9), 0.0, 1.0
        )
    else:
        k = torch.zeros_like(tau, dtype=torch.long)

    # fixed-point phase: n * c_fix mod 2^32 (see the module docstring);
    # hz/sr (`cyc`) is a host f32 division
    n = (fb - on_b) & _U32  # frames since note-on, as uint32
    cyc = bake["cyc"][idx][:, None, :]
    c_fix = (cyc * 2.0**32).to(torch.int64)
    phase_fix = (n * c_fix) & _U32
    phase = phase_fix.to(torch.float32) * (W / 2.0**32)  # [0, W]
    p0 = torch.floor(phase)
    frac = (phase - p0).reshape(-1)
    p0 = torch.clamp(p0.to(torch.int64), 0, W - 1).reshape(-1)

    # one row gather: row k*W + p holds (w_k[p], w_k[p+1], w_{k+1}[p],
    # w_{k+1}[p+1]), p+1 wrapping around the table
    knext = torch.arange(1, K + 1, device=table_waves.device)
    wk1 = table_waves[torch.clamp(knext, max=K - 1)]
    t4 = torch.stack([
        table_waves, torch.roll(table_waves, -1, dims=1),
        wk1, torch.roll(wk1, -1, dims=1),
    ], dim=2).reshape(K * W, 4)
    g = t4[k * W + p0]  # [N, 4]
    wave = g[:, 0] * (1 - frac) + g[:, 1] * frac
    if K > 1:
        w1 = g[:, 2] * (1 - frac) + g[:, 3] * frac
        wave = wave * (1 - blend) + w1 * blend
    wave = wave.reshape(alive.shape)  # [nb, bl, P]

    s = wave * velb * env * amp_mult
    s = torch.where(alive, s, 0.0)
    mono = torch.sum(s, dim=2).reshape(-1)
    return torch.stack([mono, mono], dim=1)


# the bake columns a note kernel reads, in its launcher's order: the slot
# table [nb, P], per note [N] (on, off and removal frames, velocity, the
# pitch: SampSyn's phase increment `cyc`, the Synth's `hz`, the release
# clock), per (block, note) [nb, N]; the first four int32, the others
# float32
_INT_COLS = ("idx", "on_f", "off_f", "dead_f")
_BLOCK_COLS = ("env_ads0", "env_rel0")


def _cols(pitch: str) -> tuple[str, ...]:
    return _INT_COLS + ("vels", pitch, "rel_t") + _BLOCK_COLS


_COLS = _cols("cyc")
_SYNTH_COLS = _cols("hz")


def _check(who: str, bake, cols, frames, nb, bl, tensors) -> None:
    """A note kernel's arguments: the frames, `tensors` ((name, tensor,
    shape or None) of float32) and the bake's `cols` on the frames'
    device, of their dtypes, contiguous and of their shapes."""
    dev = frames.device
    for name, t, dtype in [("frames", frames, torch.int64),
                           *((n, t, torch.float32) for n, t, _ in tensors),
                           *((k, bake.get(k), torch.int32 if k in _INT_COLS
                              else torch.float32) for k in cols)]:
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{who}: the bake has no {name}")
        if t.device != dev:
            raise ValueError(f"{who}: {name} on {t.device}, frames on "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"{who}: {name} is {t.dtype}, expected "
                            f"{dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if nb <= 0 or bl <= 0:
        raise ValueError(f"{who}: bad window of {nb} blocks of {bl}")
    idx, on_f = bake["idx"], bake["on_f"]
    if idx.dim() != 2 or idx.shape[0] != nb:
        raise ValueError(f"{who}: idx must be [{nb}, P], got "
                         f"{list(idx.shape)}")
    if on_f.dim() != 1 or on_f.shape[0] < 1:
        raise ValueError(f"{who}: on_f must be [N], N >= 1, got "
                         f"{list(on_f.shape)}")
    N = on_f.shape[0]
    want = {"frames": (frames, [nb * bl]),
            **{n: (t, shape) for n, t, shape in tensors if shape},
            **{k: (bake[k], [N]) for k in cols[1:]
               if k not in _BLOCK_COLS},
            **{k: (bake[k], [nb, N]) for k in _BLOCK_COLS}}
    for name, (t, shape) in want.items():
        if list(t.shape) != shape:
            raise ValueError(f"{who}: {name} must be {shape}, got "
                             f"{list(t.shape)}")


def _check_sampsyn(bake, frames, nb, bl, table_times, table_waves,
                   ib) -> None:
    _check("sampsyn", bake, _COLS, frames, nb, bl,
           [("ib", ib, [bl]), ("table_times", table_times, None),
            ("table_waves", table_waves, None)])
    K = table_times.shape[0] if table_times.dim() == 1 else 0
    if K < 1 or table_waves.dim() != 2 or table_waves.shape[0] != K \
            or table_waves.shape[1] < 1:
        raise ValueError("sampsyn: table_times [K] and table_waves [K, W] "
                         f"must agree, K, W >= 1, got "
                         f"{list(table_times.shape)} and "
                         f"{list(table_waves.shape)}")


# f32 operations of a live slot-frame in csrc/sampsyn.cu: the two clocks
# (2 adds), an ADS segment or the release (at most 2 subtractions, a
# division, a multiply and an add), the table clock (an add), the phase
# (a multiply, a subtraction), the lerp in a snapshot (1 - frac, 2
# multiplies, an add), the three amplitude multiplies and the slot sum's
# add; with K > 1 also the blend (2 subtractions, a division), the second
# snapshot's lerp (3) and the blend's lerp (1 - blend, 2 multiplies, an
# add)
SAMPSYN_FLOPS = 18
SAMPSYN_BLEND_FLOPS = 10


def sampsyn_work(bake: dict[str, torch.Tensor], frames: torch.Tensor,
                 nb: int, bl: int, conf: AdsrConf, table_times: torch.Tensor,
                 table_waves: torch.Tensor, ib: torch.Tensor
                 ) -> tuple[float, float]:
    """(flops, bytes) of one sampsyn: SAMPSYN_FLOPS a slot-frame (and
    SAMPSYN_BLEND_FLOPS more with K > 1 snapshots); the frames, the
    in-block clock, the bake columns it reads and the wavetable read once,
    the [nb*bl, 2] mix written once."""
    P = bake["idx"].shape[1]
    K = table_waves.shape[0]
    per = SAMPSYN_FLOPS + (SAMPSYN_BLEND_FLOPS if K > 1 else 0)
    nbytes = sum(t.numel() * t.element_size() for t in (
        frames, ib, table_times, table_waves, *(bake[k] for k in _COLS)))
    return float(nb * bl * P * per), float(nbytes + nb * bl * 2 * 4)


def _env_fields(conf: AdsrConf) -> dict:
    """csrc/note_env.cuh's envelope constants: the plain version's f32
    operands (the constants ops/adsr.py computes in numpy float32)."""
    a32, ad, ads_end = _seg_bounds(conf)

    def slope(a, b):
        return float(np.float32(b) - np.float32(a))

    return dict(
        att_base=_f32(conf.std_vel),
        att_slope=slope(conf.std_vel, conf.attack_vel),
        att_div=_f32(conf.attack_sec),
        dec_base=_f32(conf.attack_vel),
        dec_slope=slope(conf.attack_vel, conf.decay_vel),
        dec_div=_f32(conf.decay_sec),
        sus_base=_f32(conf.decay_vel),
        sus_slope=slope(conf.decay_vel, conf.sustain_vel),
        sus_div=_f32(conf.sustain_sec),
        a32=float(a32), d32=_f32(conf.decay_sec), ad=float(ad),
        ads_end=float(ads_end), sustain_vel=_f32(conf.sustain_vel),
        release_vel=_f32(conf.release_vel),
        release_div=_f32(conf.release_sec),
        att_on=int(conf.attack_sec > 0.0), dec_on=int(conf.decay_sec > 0.0),
        sus_on=int(conf.sustain_sec > 0.0),
        release_on=int(conf.release_sec > 0.0),
    )


def _sampsyn_params(conf: AdsrConf, W: int):
    """The kernel's SampSynParams: the envelope's constants, the amplitude
    as torch rounds a Python float to the tensor's f32, and W / 2^32."""
    from ..kernels import SampSynParams

    amp = 1.0 / conf.max_vel() if conf.max_vel() != 0.0 else 0.0
    return SampSynParams(**_env_fields(conf), amp=_f32(amp),
                         wscale=_f32(W / 2.0**32))


@counted(sampsyn_work)
def sampsyn(
    bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int, bl: int,
    conf: AdsrConf,
    table_times: torch.Tensor,  # [K] f32, ascending
    table_waves: torch.Tensor,  # [K, W] f32
    ib: torch.Tensor,
) -> torch.Tensor:
    """The SampSyn arm of a window, [nb*bl, 2] (see sampsyn_plain). CUDA
    tensors run the hand-written kernel; CPU tensors the plain
    version."""
    global sampsyn_launches
    _check_sampsyn(bake, frames, nb, bl, table_times, table_waves, ib)
    dev = frames.device
    if dev.type == "cpu":
        return sampsyn_plain(bake, frames, nb, bl, conf, table_times,
                             table_waves, ib)
    if dev.type != "cuda":
        raise ValueError(f"sampsyn: unsupported device {dev}")
    from ..kernels import sampsyn_launch

    out = torch.empty((nb * bl, 2), dtype=torch.float32, device=dev)
    sampsyn_launch(frames, ib, tuple(bake[k] for k in _COLS), table_times,
                   table_waves, _sampsyn_params(conf, table_waves.shape[1]),
                   out, nb, bl)
    sampsyn_launches += 1
    return out


# f32 operations of a slot-frame in synth_plain, a sine counted as one:
# the two envelope clocks, the amplitude's multiply and the slot sum's add
# (SYNTH_FLOPS), and for each oscillator on (SYNTH_OSC_FLOPS, square,
# top-flat, triangle) its envelope (an ADS segment or the release: at
# most 2 subtractions, a division, a multiply and an add), its three
# products (velocity, envelope, volume) and its add into the slot's value
# (9), and its shape:
#   square:   t*hz, x 2pi, the reduction (x / 2pi, 3 products and 3
#             subtractions), the sine, x 1/z (11);
#   top-flat: the same 10 up to the sine, + (1-z)/2, x 2/(1+z) (12);
#   triangle: t*hz, + 1/2, the subtraction, x 4, - 1 (5)
SYNTH_FLOPS = 4
SYNTH_OSC_FLOPS = (20, 21, 14)


def synth_work(bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int,
               bl: int, sq_vol: float, sq_z: float, sq_conf: AdsrConf,
               tf_vol: float, tf_z: float, tf_conf: AdsrConf, tr_vol: float,
               tr_conf: AdsrConf, time2d: torch.Tensor, ib: torch.Tensor
               ) -> tuple[float, float]:
    """(flops, bytes) of one synth: SYNTH_FLOPS a slot-frame and each
    oscillator on's SYNTH_OSC_FLOPS; the frames, time2d, the in-block
    clock and the bake columns the kernel reads, read once, the [nb*bl,
    2] mix written once."""
    P = bake["idx"].shape[1]
    per = SYNTH_FLOPS + sum(n for n, vol in zip(
        SYNTH_OSC_FLOPS, (sq_vol, tf_vol, tr_vol)) if vol > 0.0)
    nbytes = sum(t.numel() * t.element_size() for t in (
        frames, time2d, ib, *(bake[k] for k in _SYNTH_COLS)))
    return float(nb * bl * P * per), float(nbytes + nb * bl * 2 * 4)


def _synth_params(sq_vol: float, sq_z: float, sq_conf: AdsrConf,
                  tf_vol: float, tf_z: float, tf_conf: AdsrConf,
                  tr_vol: float, tr_conf: AdsrConf):
    """The kernel's SynthParams: each oscillator's on flag (volume > 0),
    f32 volume, envelope constants and the first oscillator on with equal
    ones, the shapes' constants as ops/osc.py rounds them (numpy f32),
    the amplitude as torch rounds a Python float, and sin_f32's
    constants."""
    from ..kernels import SynthEnv, SynthParams

    vols = (sq_vol, tf_vol, tr_vol)
    on = [int(v > 0.0) for v in vols]
    envs = [_env_fields(c) for c in (sq_conf, tf_conf, tr_conf)]
    env_of = [next(j for j in range(o + 1)
                   if j == o or (on[j] and envs[j] == envs[o]))
              for o in range(3)]
    amp = sq_vol * sq_conf.max_vel() + tf_vol * tf_conf.max_vel() \
        + tr_vol * tr_conf.max_vel()
    amp = 1.0 / amp if amp != 0.0 else 0.0
    p = SynthParams(on=(ctypes.c_int * 3)(*on),
                    env_of=(ctypes.c_int * 3)(*env_of),
                    vol=(ctypes.c_float * 3)(*(_f32(v) for v in vols)),
                    amp=_f32(amp), inv_2pi=osc._INV_2PI,
                    pi2_hi=osc._PI2_HI, pi2_mid=osc._PI2_MID,
                    pi2_lo=osc._PI2_LO, reduce_max=osc._REDUCE_MAX,
                    two_pi=_f32(osc.TWO_PI))
    for o in range(3):
        p.env[o] = SynthEnv(**envs[o])
    one, two = np.float32(1.0), np.float32(2.0)
    if on[0]:
        z = np.float32(sq_z)
        p.z[0], p.inv_z[0] = float(z), float(one / z)
    if on[1]:
        z = np.float32(tf_z)
        p.z[1] = float(z)
        p.half_1mz[1] = float((one - z) / two)
        p.two_1pz[1] = float(two / (one + z))
    return p


@counted(synth_work)
def synth(
    bake: dict[str, torch.Tensor], frames: torch.Tensor, nb: int, bl: int,
    sq_vol: float, sq_z: float, sq_conf: AdsrConf,
    tf_vol: float, tf_z: float, tf_conf: AdsrConf,
    tr_vol: float, tr_conf: AdsrConf,
    time2d: torch.Tensor, ib: torch.Tensor,
) -> torch.Tensor:
    """The Synth arm of a window, [nb*bl, 2] (see synth_plain). CUDA
    tensors run the hand-written kernel; CPU tensors the plain version."""
    global synth_launches
    _check("synth", bake, _SYNTH_COLS, frames, nb, bl,
           [("time2d", time2d, [nb, bl]), ("ib", ib, [bl])])
    dev = frames.device
    if dev.type == "cpu":
        return synth_plain(bake, frames, nb, bl, sq_vol, sq_z, sq_conf,
                           tf_vol, tf_z, tf_conf, tr_vol, tr_conf, time2d,
                           ib)
    if dev.type != "cuda":
        raise ValueError(f"synth: unsupported device {dev}")
    from ..kernels import synth_launch

    out = torch.empty((nb * bl, 2), dtype=torch.float32, device=dev)
    synth_launch(frames, time2d, ib, tuple(bake[k] for k in _SYNTH_COLS),
                 _synth_params(sq_vol, sq_z, sq_conf, tf_vol, tf_z, tf_conf,
                               tr_vol, tr_conf), out, nb, bl)
    synth_launches += 1
    return out
