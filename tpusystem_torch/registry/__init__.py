from tpusystem_torch.registry.accessors import (
    Registry,
    getarguments,
    gethash,
    getmetadata,
    getname,
    register,
    sethash,
    setname,
)

__all__ = ['Registry', 'register', 'getarguments', 'getname', 'gethash',
           'sethash', 'setname', 'getmetadata']
