"""The small sizes of the cells whose tests live in their own files, added
to the harness tests' table (``test_portbench_harness.TINY``), so that the
rehearsals parametrised over every cell cover them as well."""

from portbench.tests import test_portbench_harness, test_portbench_lft

test_portbench_harness.TINY.setdefault(test_portbench_lft.CELL, test_portbench_lft.TINY_LFT)
