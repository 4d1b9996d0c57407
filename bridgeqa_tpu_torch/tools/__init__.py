"""The offline tools: the declarative rewrites of the questions
(``compose_decl``), question-conditional view selection with BLIP-ITM
(``view_select``) and the back-projection of per-frame features, labels and
colours onto scene points (``projection``)."""
