"""BA problem model (tensor dataclasses and load-time tables)."""
