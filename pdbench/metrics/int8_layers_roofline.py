"""The int8 layers' share of their roofline, in %: over every `QuantDense`
and `QuantConv` call of the traced request's denoiser, the sum of each
call's least time from its shapes (`counts/layers.py`: int8 operations at
1,979 TOP/s or its activation, weight codes and bf16 output at 3.35 TB/s)
over the device time inside those calls (the activation's quantization,
the int8 GEMM or K8, the dequantization). Nothing in a cell without int8
layers."""


def read(rec):
    fine = rec["fine"]
    if fine is None:
        return None
    calls = [c for c in fine["calls"] if c["key"][0] == "int8_layer"]
    device_us = sum(c["total_us"] for c in calls)
    if not calls or device_us <= 0:
        return None
    return 100.0 * sum(c["key"][1] for c in calls) * 1e6 / device_us
