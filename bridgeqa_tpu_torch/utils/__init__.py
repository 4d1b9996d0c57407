"""Run logging (``logging_utils``) and profiling hooks (``profiling``)."""
