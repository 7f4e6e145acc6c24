"""The window's share of the card's peak, in %: the least time of the work
every completed request needs (its matrix products, convolutions and
attention products counted from the configuration's shapes; int8 at
1,979 and bf16 at 989 TOP/s, `counts/layers.py`) over the window's
seconds."""


def read(rec):
    win = rec["window"]
    return 100.0 * rec["least_s_per_request"] * win["requests"] / win["seconds"]
