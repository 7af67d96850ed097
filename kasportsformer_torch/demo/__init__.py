"""Host-side demo helpers the serving path needs (camera math, clip cutting)."""
