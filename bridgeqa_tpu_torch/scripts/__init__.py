"""The port's drivers, run as ``python -m bridgeqa_tpu_torch.scripts.<name>``:
``train``, ``predict``, ``eval`` and ``score`` (``common`` holds what they
share), and the offline tools ``view_select``, ``compute_multiview_features``,
``project_multiview_{features,labels,color}``, ``verify_parity``,
``profile_loader`` and ``profile_train``."""
