"""The streamed extraction's share of the host link's peak: the bytes it
copied from the host cube to the card (``stream_bytes``) over the summed
time of its ``aperture.stream`` spans, as a share of PCIe Gen5 x16's rate
in one direction.  The span closes once the last chunk's copies and
launch have finished, so the rate cannot exceed what the link moved.
None where the program has no such span or counter."""

#: B/s: PCIe Gen5 x16, one direction (the NVIDIA H100 SXM data sheet's
#: 128 GB/s for both directions of the host interface).
LINK_BYTES_PER_S = 64e9


def read(run):
    t = run.get("timers") or {}
    if not t.get("stream_bytes") or not t.get("aperture.stream"):
        return None
    return 100.0 * t["stream_bytes"] / t["aperture.stream"] / LINK_BYTES_PER_S
