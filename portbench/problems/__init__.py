"""The problems, one module a configuration: make(config, seed)."""
