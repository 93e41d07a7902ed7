"""The bead finder a frame (ms): ``stage_report()["find_beads"]``, host
wall time around ``BeadFinder`` (detection on the card, masks and crops
on the host). Layer: bead finder (``components/find.py``)."""


def read(trace, cfg):
    stage = trace.stages.get("find_beads")
    if stage is None or not trace.frames:
        return None
    return 1e3 * stage["seconds"] / trace.frames
