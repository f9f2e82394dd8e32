"""Backbone families of the reference, one module a family, found by the
configuration's ``architecture.family`` (as ``flops/<family>.py`` is).

A family module gives:

* ``MODULE``: the program's name for the net, which the state dict nests as
  ``backbone.backbone.<MODULE>``;
* ``Net(arch, precision)``: the net under the program's parameter names, with
  ``stem(images)`` (``[B, H, W, 3]`` -> tokens, before the dropout that
  training applies to the whole batch) and ``body(tokens)`` (-> final tokens);
* ``features(tokens)``: final tokens -> (patch tokens ``[B, N, D]``, global
  feature ``[B, D]``).

Built from ``reference/layers.py`` (``Dense``, ``Conv``, ``LayerNorm``,
``attention``), a family gets the weight plan, the served dtypes and the
float8 control without code of its own; a configuration with a new family
adds its file here (and ``flops/<family>.py``) and changes nothing else.
"""
