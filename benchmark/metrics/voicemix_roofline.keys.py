"""The voice mix kernel's share of its roofline over the traced bounces
of a sampled-instrument session: the least time of the session's voice
mixes (harness/work_keys.py, from the spec, kept by loops/bounce_keys.py)
times the bounces traced, over the profiled seconds of the kernels whose
name holds `voice_mix`. Nothing to read where the card has no peaks in
the table or no such kernel ran."""

from benchmark.harness import work_keys


def read(run):
    t = run.trace
    work = getattr(run, "voicemix_work", None)
    if (t is None or t.units <= 0 or work is None
            or run.device_kind not in work_keys.PEAKS):
        return None
    spent = sum(s for name, s in t.kernels.items() if "voice_mix" in name)
    if spent <= 0:
        return None
    least = work_keys.least_s(*work, work_keys.PEAKS[run.device_kind])
    return 100.0 * least * t.units / spent
