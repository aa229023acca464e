"""The Synth arm's wrapper (termdaw_tpu_torch/ops/synthv.synth) on the CPU:
CPU tensors run the plain version (synth_plain, the body the window
program ran before the arm had a kernel) and return what it returns, bit
for bit, at c4's bass shape and at a small instrument-session shape; the
wrapper's checks of devices, dtypes, shapes, contiguity and columns; the
kernel's constants (SynthParams) against the plain version's f32
operands; its work formula; and a CPU window's count
(utils/roofline.count_work) of the arm, which is that formula and none of
the plain version's ops. The kernel itself (csrc/synth.cu) is held to
the plain version on the card in tests/test_torch_cuda.py. Imports
nothing of JAX or termdaw_tpu."""

import numpy as np
import pytest
import torch

from termdaw_tpu_torch.ops import osc, synthv
from termdaw_tpu_torch.ops.adsr import AdsrConf, hit_conf
from termdaw_tpu_torch.utils import roofline
from termdaw_tpu_torch.utils.fixtures import (
    load_state, synth_window, write_c3_project,
)

CPU = torch.device("cpu")
# c4's bass (utils/fixtures.write_c4_project): square and top-flat, each
# with its own ADSR, the triangle off
HIT = hit_conf(0.001, 0.02, 0.0, 0.0, 0.0, 0.0)
NOTE = hit_conf(0.01, 0.1, 0.8, 5.0, 0.2, 0.5)
C4_BASS = (0.4, 0.3, HIT, 1.0, 0.8, NOTE, 0.0, AdsrConf())
# the instrument session's Synths (benchmark/configs/c9_poly32.json): all
# three oscillators on one ADSR
POLY = hit_conf(0.01, 0.2, 0.8, 3.0, 0.4, 0.8)
C9 = (0.5, 0.6, POLY, 0.7, 0.8, POLY, 0.6, POLY)


def _clone(args):
    return tuple({k: v.clone() for k, v in a.items()} if isinstance(a, dict)
                 else a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


def _call(window, oscs):
    bake, frames, time2d, ib = window
    nb, bl = time2d.shape
    return (bake, frames, nb, bl, *oscs, time2d, ib)


# (window: nb, bl, P, N; oscillators)
SHAPES = {"c4_bass": (dict(nb=4, bl=1024, P=2, N=6), C4_BASS),
          "c9_small": (dict(nb=3, bl=1024, P=32, N=64, empty=0.5), C9)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_synth_on_cpu_returns_the_plain_body(shape):
    """The wrapper's dispatch on CPU tensors at c4's bass shape (2 slots,
    square and top-flat with two envelopes) and at an instrument
    session's (32 slots, all three oscillators on one envelope), 3-4
    blocks of 1024 frames: it returns synth_plain's bits, on fresh
    arguments and on those of a first call, and counts no launch."""
    w, oscs = SHAPES[shape]
    args = _call(synth_window(CPU, seed=5, **w), oscs)
    n0 = synthv.synth_launches
    got = synthv.synth(*args)
    want = synthv.synth_plain(*_clone(args))
    assert float(want.abs().max()) > 0.1
    assert torch.equal(got, want)
    assert torch.equal(synthv.synth(*args), got)
    assert synthv.synth_launches == n0


def _args(nb=4, bl=64, P=4, N=6):
    return list(_call(synth_window(CPU, nb, bl, P, N, seed=1), C4_BASS))


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _all_meta(a):
    a[0] = {k: _meta(v) for k, v in a[0].items()}
    for i in (1, 12, 13):
        a[i] = _meta(a[i])


def _bake(key, fn):
    def f(a):
        a[0] = dict(a[0])
        a[0][key] = fn(a[0][key])
    return f


def _arg(i, fn):
    def f(a):
        a[i] = fn(a[i])
    return f


def _drop(key):
    def f(a):
        a[0] = {k: v for k, v in a[0].items() if k != key}
    return f


def _strided(t):
    return torch.stack([t, t], dim=-1)[..., 0]  # same shape, stride 2


BAD = {
    "device_bake": (_bake("hz", _meta), ValueError, "hz on meta"),
    "device_time2d": (_arg(12, _meta), ValueError, "time2d on meta"),
    "device_ib": (_arg(13, _meta), ValueError, "ib on meta"),
    "device_unsupported": (_all_meta, ValueError, "unsupported device"),
    "dtype_idx": (_bake("idx", lambda t: t.long()), TypeError, "idx is"),
    "dtype_dead_f": (_bake("dead_f", lambda t: t.long()), TypeError,
                     "dead_f is"),
    "dtype_hz": (_bake("hz", lambda t: t.double()), TypeError, "hz is"),
    "dtype_frames": (_arg(1, lambda t: t.int()), TypeError, "frames is"),
    "dtype_time2d": (_arg(12, lambda t: t.double()), TypeError,
                     "time2d is"),
    "missing_hz": (_drop("hz"), ValueError, "has no hz"),
    "missing_env_ads0": (_drop("env_ads0"), ValueError, "has no env_ads0"),
    "shape_idx": (_bake("idx", lambda t: t[:-1].contiguous()), ValueError,
                  "idx must be"),
    "shape_frames": (_arg(1, lambda t: t[:-1].contiguous()), ValueError,
                     "frames must be"),
    "shape_time2d": (_arg(12, lambda t: t[:, :-1].contiguous()), ValueError,
                     "time2d must be"),
    "shape_ib": (_arg(13, lambda t: torch.cat([t, t[:1]])), ValueError,
                 "ib must be"),
    "shape_hz": (_bake("hz", lambda t: t[:-1].contiguous()), ValueError,
                 "hz must be"),
    "shape_env_rel0": (_bake("env_rel0", lambda t: t[:, :-1].contiguous()),
                       ValueError, "env_rel0 must be"),
    "contiguous_time2d": (_arg(12, _strided), ValueError,
                          "time2d is not contiguous"),
    "contiguous_vels": (_bake("vels", _strided), ValueError,
                        "vels is not contiguous"),
    "contiguous_frames": (_arg(1, _strided), ValueError,
                          "frames is not contiguous"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_synth_wrapper_refuses_bad_arguments(case):
    """Each wrong device, dtype, shape, contiguity or missing column
    raises before anything runs; the arguments as they come run. The
    Synth reads `hz` where SampSyn reads `cyc`, so it runs without `cyc`."""
    change, err, match = BAD[case]
    a = _args()
    assert synthv.synth(*a).shape == (4 * 64, 2)
    a0 = list(a)
    a0[0] = {k: v for k, v in a[0].items() if k != "cyc"}
    assert torch.equal(synthv.synth(*a0), synthv.synth(*a))
    change(a)
    with pytest.raises(err, match=match):
        synthv.synth(*a)


# oscillators on (square, top-flat, triangle)
ON = {"all": (1, 1, 1), "c4_bass": (1, 1, 0), "square": (1, 0, 0),
      "top_flat": (0, 1, 0), "triangle": (0, 0, 1), "none": (0, 0, 0)}


@pytest.mark.parametrize("on", sorted(ON))
def test_synth_work_formula(on):
    """SYNTH_FLOPS (4: the clocks, the amplitude, the slot sum) a
    slot-frame and, for each oscillator on, its SYNTH_OSC_FLOPS (square
    20, top-flat 21, triangle 14); the frames (int64), time2d, the
    in-block clock and the nine bake columns read once, the stereo mix
    written once."""
    nb, bl, P, N = 5, 48, 3, 7
    a = list(_call(synth_window(CPU, nb, bl, P, N, seed=2), C9))
    for i, o in zip((4, 7, 10), ON[on]):
        a[i] = a[i] if o else 0.0
    flops, nbytes = synthv.synth_work(*a)
    per = 4 + sum(n for n, o in zip((20, 21, 14), ON[on]) if o)
    assert flops == nb * bl * P * per
    ins = (nb * bl * 8 + nb * bl * 4 + bl * 4 + nb * P * 4 + 6 * N * 4
           + 2 * nb * N * 4)
    assert nbytes == ins + nb * bl * 2 * 4
    with roofline.count_work() as w:
        synthv.synth(*a)
    assert w.ops == {"kernel:synth": [1, flops, nbytes]}


def test_cpu_window_counts_the_synth_arm_as_its_formula(tmp_path,
                                                        monkeypatch):
    """window_cost of a c3 window on the CPU counts the Synth bass as one
    `kernel:synth` row of synth_work's numbers for the window's arguments
    (square and top-flat on: 4 + 20 + 21 a slot-frame), and none of the
    plain version's own ops (the rounding of its sines' reduction),
    though the plain version ran."""
    write_c3_project(tmp_path, 2.0, 8000, 64)
    st = load_state(tmp_path, CPU)
    calls = []
    plain = synthv.synth_plain

    def spy(*args):
        calls.append(_clone(args))
        return plain(*args)

    monkeypatch.setattr(synthv, "synth_plain", spy)
    (nb,) = roofline._window_counts(st)
    cost = st.compiled.window_cost(st.fb, nb)
    assert len(calls) == 1
    flops, nbytes = synthv.synth_work(*calls[0])
    assert cost["ops"]["kernel:synth"] == [1, flops, nbytes]
    assert flops == nb * 64 * calls[0][0]["idx"].shape[1] * 45
    assert not any("round" in k for k in cost["ops"])


def test_synth_params_are_the_plain_versions_operands():
    """The kernel's constants: each oscillator's on flag and f32 volume,
    its envelope's constants (SampSyn's, ops/synthv._env_fields), the
    first oscillator on whose constants equal its own, the shapes'
    constants as ops/osc.py rounds them in numpy f32, the amplitude as
    torch rounds a Python float, and sin_f32's constants."""
    f32 = np.float32
    odd = AdsrConf(0.2, 0.0, 1.0, 0.05, 0.5, 0.1, 0.3, 0.0, 0.0)
    p = synthv._synth_params(0.5, 0.6, odd, 0.7, 0.3, NOTE, 0.6, odd)
    assert list(p.on) == [1, 1, 1] and list(p.env_of) == [0, 1, 0]
    assert list(p.vol) == [float(f32(v)) for v in (0.5, 0.7, 0.6)]
    assert p.z[0] == float(f32(0.6))
    assert p.inv_z[0] == float(f32(1.0) / f32(0.6))
    assert p.z[1] == float(f32(0.3))
    assert p.half_1mz[1] == float((f32(1.0) - f32(0.3)) / f32(2.0))
    assert p.two_1pz[1] == float(f32(2.0) / (f32(1.0) + f32(0.3)))
    amp = 1.0 / (0.5 * odd.max_vel() + 0.7 * NOTE.max_vel()
                 + 0.6 * odd.max_vel())
    assert p.amp == float(f32(amp))
    for o, conf in enumerate((odd, NOTE, odd)):
        want = synthv._env_fields(conf)
        assert {k: getattr(p.env[o], k) for k in want} == want
    e = p.env[0]
    assert (e.att_on, e.dec_on, e.sus_on, e.release_on) == (0, 1, 1, 0)
    assert e.att_slope == float(f32(1.0) - f32(0.2))
    assert e.ads_end == float(f32(f32(f32(0.0) + f32(0.05)) + f32(0.1)))
    assert (p.inv_2pi, p.pi2_hi, p.pi2_mid, p.pi2_lo, p.reduce_max) == (
        osc._INV_2PI, osc._PI2_HI, osc._PI2_MID, osc._PI2_LO,
        osc._REDUCE_MAX)
    assert p.two_pi == float(f32(osc.TWO_PI))
    # c9's three oscillators share one envelope; c4's bass has two, the
    # triangle off; an oscillator that is off shares with none
    assert list(synthv._synth_params(*C9).env_of) == [0, 0, 0]
    bass = synthv._synth_params(*C4_BASS)
    assert list(bass.on) == [1, 1, 0] and list(bass.env_of) == [0, 1, 2]
    off = synthv._synth_params(0.0, 0.6, NOTE, 0.7, 0.3, NOTE, 0.6, NOTE)
    assert list(off.env_of) == [0, 1, 1]
    silent = synthv._synth_params(0.0, 0.6, NOTE, 0.0, 0.3, NOTE, 0.0, NOTE)
    assert silent.amp == 0.0 and list(silent.on) == [0, 0, 0]
