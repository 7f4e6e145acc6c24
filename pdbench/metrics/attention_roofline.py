"""The denoiser's attention's share of its roofline, in %: over every
attention call of the traced request (a `CrossAttention` less its four
projections, a `JointBlock.attention`), the least time from the q, k and v
shapes (`counts/layers.py::attention_s`, the same whatever kernel runs it)
over the device time inside the call."""


def read(rec):
    fine = rec["fine"]
    if fine is None:
        return None
    calls = [c for c in fine["calls"] if c["key"][0] == "attention"]
    device_us = sum(c["self_us"] for c in calls)
    if not calls or device_us <= 0:
        return None
    return 100.0 * sum(c["key"][1] for c in calls) * 1e6 / device_us
