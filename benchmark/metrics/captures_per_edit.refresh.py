"""Window programs made per edit: the refreshed graphs' `captures`
counters (graph/compile.py; on the card each is a captured CUDA graph)
summed over the window's edits, over the edits. An exact count."""


def read(run):
    if getattr(run, "attempted", 0) <= 0 or not hasattr(
            run, "captures_in_window"):
        return None
    return run.captures_in_window / run.attempted
