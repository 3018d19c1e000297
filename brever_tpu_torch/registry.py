"""Name -> object registries (counterpart of ``brever_tpu/registry.py``,
with the same ``register``/``get``/``keys`` surface)."""


class Registry:
    """A named mapping from string keys to registered objects."""

    def __init__(self, tag):
        self.tag = tag
        self._items = {}

    def register(self, name):
        def decorator(obj):
            if name in self._items:
                raise ValueError(f'"{name}" is already registered in the '
                                 f'{self.tag} registry')
            self._items[name] = obj
            return obj
        return decorator

    def get(self, name):
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(f'"{name}" is not in the {self.tag} registry; '
                           f'available: {sorted(self._items)}') from None

    def keys(self):
        return self._items.keys()

    def __contains__(self, name):
        return name in self._items

    def __iter__(self):
        return iter(self._items)
