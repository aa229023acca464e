"""The plain reference: termdaw's semantics in float64 numpy and scipy,
written from the upstream project's rules (the repo's per-frame float64
oracle, tests/oracle.py, and the effects' float64 sequential forms,
tests/test_fx_oracle.py), vectorised over the song. It imports nothing of
the program, of JAX or of the JAX package, and reads only the project's
raw files and spec."""
