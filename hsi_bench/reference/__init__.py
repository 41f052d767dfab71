"""The plain reference that decides ``correct``: PyTorch in float32 with
TF32 off, no kernels, no batching tricks. It imports nothing of the port:
the benchmark hands it the weights and inputs it made from the seed, and
it works out every crop, mask and dropout multiplier again from the seed
(``draws.py``, frozen copies of the recipe's draw order and of the dropout
hash). The one thing of the program's that it takes is the training
state before a replayed chunk, which it follows from there (see
``traffic/train_superstep.py``).

``model.py``: the encoder, the SimMIM loss and the classifier as
functions of a dict of named weights. ``train.py``: steps of the SimMIM
recipe (clamp, AdamW) from the seed's weights or from a given state. ``serve.py``: the classifier's logits in
blocks of rows. ``quant.py``: the rounding of matrix operands that the
control applies (fp8) and the identity that the reference applies.
"""
