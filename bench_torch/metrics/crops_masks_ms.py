"""The chip finder's host ROI crops and fg/bg masks a frame (ms):
``components.find.last_chip_timings["host_crops_masks_s"]``, read after
each frame. Layer: chip finder host (``components/find.py``
``ButtonFinder``)."""


def read(trace, cfg):
    vals = [t["host_crops_masks_s"] for t in trace.chip_timings
            if "host_crops_masks_s" in t]
    return 1e3 * sum(vals) / len(vals) if vals else None
