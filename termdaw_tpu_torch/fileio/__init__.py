"""Carried over from termdaw_tpu/fileio/__init__.py, so that the port imports
nothing of termdaw_tpu; the code is unchanged.

File-format IO: WAV codec, MIDI (SMF) parsing, wavetables, floww packets.

Everything here is first-party. The reference delegates these to external
Rust crates (`hound` for WAV, `floww` for MIDI+packets, `sampsyn` for
wavetables — reference Cargo.toml:12-24); the target environment has none of
them, so this package owns the formats.
"""
