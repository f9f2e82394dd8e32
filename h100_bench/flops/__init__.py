"""Model FLOPs from shapes: two per multiply-add, every matrix product and
convolution of the forward (elementwise work, softmax and FFTs not counted).
One module per backbone family (``swin``, ``vit``), found by the
configuration's ``architecture.family``, and ``heads`` for what follows the
backbone.  A training step counts three forwards (the backward as twice the
forward); recomputation under checkpointing is not counted."""
