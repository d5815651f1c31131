"""Model layers and assembly of the port (serving path of repro.models)."""
