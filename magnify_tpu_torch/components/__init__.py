"""Components registered on import: the pipeline stages of the bead and
chip paths and ``quantify``."""

from magnify_tpu_torch.components import (  # noqa: F401
    filter,
    find,
    identify,
    postprocess,
    preprocess,
    quantify,
    stitch,
)
