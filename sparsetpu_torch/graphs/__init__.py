"""Host-side graph generators (numpy), ported from ``sparsetpu.graphs``."""
