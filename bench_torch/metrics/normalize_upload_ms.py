"""The chip finder's host uint8 normalization and upload of the searched
plane a frame (ms): ``components.find.last_chip_timings
["normalize_upload_s"]``, read after each frame. Layer: chip finder host
(``components/find.py`` ``ButtonFinder``)."""


def read(trace, cfg):
    vals = [t["normalize_upload_s"] for t in trace.chip_timings
            if "normalize_upload_s" in t]
    return 1e3 * sum(vals) / len(vals) if vals else None
