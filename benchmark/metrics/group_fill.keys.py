"""The share of the fused SampleMulti groups' voice-table slots that held
a voice over the window: 100 times the rise of the program's
`group_voices` over that of its `group_slots` (the [nb, Pf] tables of
every window rendered, live or served), as loops/bounce_keys.py keeps
them. Nothing to read where the program has no such counters or rendered
no slot."""


def read(run):
    fill = getattr(run, "group_fill", None)
    if not fill or fill[0] <= 0:
        return None
    return 100.0 * fill[1] / fill[0]
