"""Run parameters and the reference-format deck parser.

Copied from hifiles_tpu/config/__init__.py (lines 1-2).
"""

from .deck import Deck
from .params import RunInput, BCParams
