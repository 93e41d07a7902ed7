"""Components registered on import: the bead path's pipeline stages."""

from magnify_tpu_torch.components import (  # noqa: F401
    find,
    identify,
    postprocess,
    preprocess,
    stitch,
)
