"""termdaw_tpu_torch — the PyTorch/CUDA port of termdaw_tpu.

A second package beside `termdaw_tpu/` (the JAX reference, which stays as
it is). It takes the same `project.toml` and Lua script and renders the
same WAV, with PyTorch tensors on an explicit device and hand-written
CUDA kernels for Hopper where the reference had Pallas kernels.

This package imports `torch`, never `jax`, and nothing of `termdaw_tpu`.
Every module of the reference that it needs, the host layers included
(`lua`, `fileio`, `banks.flowwbank`, `banks.bufferbank`, `config`,
`utils.term`, `utils.prof.span`, `engine.sink`, `workflows.palette`), is
carried over as a module of its own at the same relative path, whose
docstring names the file it came from.

Ported so far: the offline render (`State.render`) and playback (`play`
in the manual workflow) of graphs made of every vertex kind: Sum,
Normalize, SampleLoop, SampleMulti, SampleLerp, DebugSine, Synth,
SampSyn, Adsr, BandPass and the native effects behind `load_lv2` /
`add_lv2fx` (reverb, chorus, compressor, tape, delay, bitcrush, eq3,
flanger).

    python -m termdaw_tpu_torch [--device cuda|cpu] [workdir]
"""

from .device import set_full_f32

set_full_f32()

__version__ = "0.1.0"
