"""The CPU test sizes of the configurations and traffic mixes that
``bench/tests/small.py`` does not list, registered for every test under
``bench/`` (the benchmark's existing files are left as they are when a cell
is added)."""

from bench.tests import small

small.SMALL_CONFIG.setdefault("graph500", {"scale": 9})
small.SMALL_TRAFFIC.setdefault("decompose", {"warm_scale": 7})
