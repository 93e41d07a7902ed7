"""Host pre-stages a frame (ms): the pipeline's stage timers
(``diagnostics.stage_report()``) of every stage before ``find_beads``
(read, standardize_format, flatfield_correct, stitch). Layer: pipeline
(``core/pipeline.py``, ``components/preprocess.py``, ``stitch.py``)."""


def read(trace, cfg):
    names = list(trace.stages)
    if "find_beads" not in names or not trace.frames:
        return None
    pre = names[:names.index("find_beads")]
    return 1e3 * sum(trace.stages[n]["seconds"] for n in pre) / trace.frames
