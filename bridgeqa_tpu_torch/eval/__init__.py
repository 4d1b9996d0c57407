"""Evaluation: detection AP (``detection_eval``), QA and grounding metrics
(``qa_eval``) and answer scoring (``scoring``)."""
