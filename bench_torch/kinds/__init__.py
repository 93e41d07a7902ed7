"""One module per kind of configuration (``"kind"`` in its JSON file):
the frame generator, the call into the program, and the plain reference
with the comparison that decides ``correct``.

A kind module provides:

* ``make_frames(cfg, seed, count, device)``: ``count`` distinct frames
  drawn from ``seed`` (generated on ``device``, handed to the program as
  host arrays), each a dict with the input and its truth;
* ``make_call(cfg, traffic, device)``: one frame -> the program's result;
* ``to_input(cfg, frame)``: what one call takes;
* ``extract(cfg, result)``: the compared arrays of a result, as numpy;
* ``expected(cfg, frame, quantum=1)``: the plain reference's answer;
  ``quantum=2`` gives the control, the same answer at half resolution;
* ``compare(cfg, want, got)``: {number: value}, each held against
  ``LIMITS[number]``.
"""
