"""Share of the traced request (its first marker to its last) in which no
operation ran on the device, in %. The request carries spans around its
stages only, a few markers a step, so the host's pace is as in the window."""

from pdbench.tracing import busy_us


def read(rec):
    coarse = rec["coarse"]
    if coarse is None:
        return None
    req = next(c for c in coarse["calls"] if c["key"] == ("request",))
    length = req["end"] - req["start"]
    busy = busy_us([(s, e) for _, s, e, _ in coarse["activities"]
                    if req["start"] <= s and e <= req["end"]])
    return 100.0 * (1.0 - busy / length) if length > 0 else None
