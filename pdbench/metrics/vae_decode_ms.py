"""Device milliseconds of the VAE decode of one request (`decode_latents`:
the post-quant conv and the decoder), from the stage spans of the traced
request."""


def read(rec):
    coarse = rec["coarse"]
    if coarse is None:
        return None
    calls = [c for c in coarse["calls"] if c["key"] == ("stage", "vae_decode")]
    return sum(c["total_us"] for c in calls) / 1e3 if calls else None
