"""Visualization layer (matplotlib based, GUI-optional): the torch port's copy
of ``magnify_tpu.plot``.

``imshow``/``roishow`` marker overlays, the ``mrbles_clusters`` ratio
scatter, and the interactive step-tuning UI (:mod:`.vis`) behind
``interactive=True`` and ``find_circles(gui=...)``, which runs headless
(each stage once, with its defaults) where matplotlib or a GUI backend is
missing. Importing the package imports no matplotlib (the JAX package
applies its style on import; here the first plot applies it); the plots
raise ImportError without it.
"""

__all__ = ["imshow", "roishow", "mrbles_clusters", "set_style"]

from magnify_tpu_torch.plot.image import imshow, roishow
from magnify_tpu_torch.plot.mrbles import mrbles_clusters
from magnify_tpu_torch.plot.style import set_style
