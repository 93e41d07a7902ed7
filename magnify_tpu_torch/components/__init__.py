"""Components registered on import: the pipeline stages of the bead and
chip paths."""

from magnify_tpu_torch.components import (  # noqa: F401
    filter,
    find,
    identify,
    postprocess,
    preprocess,
    stitch,
)
