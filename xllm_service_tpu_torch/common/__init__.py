"""Framework-neutral types shared by the engine (copies of the reference's
pure-Python modules, trimmed to what the engine uses)."""
