"""Frames completed a second: the frames of the window over its length,
from its start to the end of its last frame."""


def read(window):
    return window.frames / window.seconds if window.seconds > 0 else None
