"""``csrc/perimeter_score.cu``'s share of its roofline (%): the bound of
the window's scorer calls (``roofline.perimeter_work``, from what each
call's circles touch on its planes) over the device time of the
``perimeter_score`` kernel. The inputs of the calls of the first pass over
the frame pool are kept and counted after the window; the window holds
whole passes, each making the same calls. Layer: kernels."""

import inspect

from bench_torch import roofline


def _record(trace, records, args, kwargs, call):
    if trace.first_cycle:
        records.append((args, kwargs))
    return call()


SPIES = (("magnify_tpu_torch.ops.detect", "score_circles", _record),)


def read(trace, cfg):
    from magnify_tpu_torch.ops import score

    records = trace.records.get("perimeter_score_roofline")
    if not records or not trace.cycles:
        return None
    sig = inspect.signature(score.score_circles)
    total = 0.0
    for args, kwargs in records:
        a = sig.bind(*args, **kwargs)
        a.apply_defaults()
        a = a.arguments
        circles, valid, max_r = a["circles"], a["valid"], a["max_radius"]
        pad = a["pad"] if a["pad"] is not None else 2 * max_r
        n_valid, hits, touched, touched_edges = roofline.perimeter_counts(
            a["edges"], circles, valid, max_r, pad)
        n = circles.numel() // 3
        total += roofline.bound_s(*roofline.perimeter_work(
            n, valid is not None, n_valid, circles.ndim == 3, hits, touched,
            touched_edges))
    return roofline.share_pct(trace, total * trace.cycles, "perimeter_score")
