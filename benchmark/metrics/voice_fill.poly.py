"""The share of the note arms' slots that held a voice over the window:
100 times the rise of the program's `note_voices` over that of its
`note_slots` (the [nb, P] instance tables of every window rendered, live
or served), as loops/bounce_poly.py keeps them. Nothing to read where the
program has no such counters or rendered no slot."""


def read(run):
    fill = getattr(run, "note_fill", None)
    if not fill or fill[0] <= 0:
        return None
    return 100.0 * fill[1] / fill[0]
