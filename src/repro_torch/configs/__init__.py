"""Architecture configs, copied from ``repro.configs`` (``registry.get_config``)."""
