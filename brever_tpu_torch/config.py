"""A model directory's ``config.yaml`` (counterpart of ``get_config`` and
``BreverConfig`` in ``brever_tpu/config.py``, which the port does not
import).

``get_config`` loads the file with PyYAML's full ``Loader``, so that the
``!!set`` tag the JAX package writes for ``val_metrics`` loads as a set.
``BreverConfig`` is the same immutable nested attribute config: ``to_dict``,
``get_field``, the typed ``set_field`` and the content hash ``get_hash``
that names a model directory.
"""

import hashlib

import yaml


def get_config(path):
    with open(path) as f:
        return BreverConfig(yaml.load(f, Loader=yaml.Loader))


class BreverConfig:
    """Immutable nested attribute config."""

    def __init__(self, dict_):
        for key, value in dict_.items():
            if isinstance(value, dict):
                value = BreverConfig(value)
            object.__setattr__(self, key, value)

    def __setattr__(self, attr, value):
        raise AttributeError(
            f'{type(self).__name__} objects are immutable')

    def to_dict(self):
        return {key: value.to_dict() if isinstance(value, BreverConfig)
                else value for key, value in self.__dict__.items()}

    def get_hash(self, length=8):
        """SHA-256 of the sorted nested dict (sets sorted), as the JAX
        package computes it."""

        def normalize(d):
            out = {}
            for key in sorted(d):
                value = d[key]
                if isinstance(value, dict):
                    out[key] = normalize(value)
                elif isinstance(value, set):
                    out[key] = sorted(value)
                else:
                    out[key] = value
            return out

        canonical = str(normalize(self.to_dict()).items())
        return hashlib.sha256(canonical.encode()).hexdigest()[:length]

    def get_field(self, key_list):
        value = getattr(self, key_list[0])
        return value if len(key_list) == 1 else value.get_field(key_list[1:])

    def set_field(self, key_list, value):
        """Set a leaf; the new value must have the current value's type."""
        if len(key_list) > 1:
            self.get_field(key_list[:-1]).set_field(key_list[-1:], value)
            return
        key = key_list[0]
        current = getattr(self, key)
        if not isinstance(value, type(current)):
            raise TypeError(
                f'attribute {key} must be {type(current).__name__}, got '
                f'{type(value).__name__}')
        object.__setattr__(self, key, value)
