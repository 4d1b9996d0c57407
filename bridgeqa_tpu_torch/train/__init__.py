"""Training of the port: the 3-group AdamW (``optim``) and the train and
eval steps (``step``)."""
