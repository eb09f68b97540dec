from . import evaluation  # noqa: F401
from .timer import tic, toc  # noqa: F401
from .misc import assert_outpath, mkdir, sigmoid, sigmoid_range, touch  # noqa: F401
