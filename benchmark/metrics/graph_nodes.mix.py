"""Device nodes the window programs replayed a bounce: the rise of the
program's `replayed_nodes` counter (each captured program's kernel, copy
and set nodes, counted once at its capture, added at each replay) over
the window, over the window's bounces, as loops/bounce_ref.py keeps it.
Nothing to read where the program has no such counter."""


def read(run):
    return getattr(run, "graph_nodes", None)
