"""Settings shared by every test of the repository.

The benchmark's CPU tests run each configuration at a small grid
(``perfbench/conftest.py:SMALL_GRIDS``).  The benchmark's files are
added to and never edited, so a configuration added after that table
takes its test grid here.
"""

from perfbench.conftest import SMALL_GRIDS

SMALL_GRIDS.setdefault("croft-1024-default", [16, 16, 16])
# y and z two-level (16 x 8): the strided products, the contiguous
# axis's plain version and the donated outputs of both
SMALL_GRIDS.setdefault("croft-1024-c128", [16, 128, 128])
