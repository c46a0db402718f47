"""Attribute-access dict (reference: dnnlib/util.py:40-53 EasyDict).

The port's own copy of ``afcm_tpu/utils/easydict.py`` (host code, numpy
only): the port imports nothing of the JAX package.
"""


class EasyDict(dict):
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]
