from .loader import ConfigError, compose_config, load_yaml, parse_overrides

__all__ = ["ConfigError", "compose_config", "load_yaml", "parse_overrides"]
