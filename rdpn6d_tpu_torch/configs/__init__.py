"""Python config modules of the port; each exposes ``get_config()``."""
