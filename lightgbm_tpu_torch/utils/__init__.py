"""Host utilities (logging)."""
