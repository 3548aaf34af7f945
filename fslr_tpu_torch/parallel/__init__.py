"""Data parallelism of the port: a device mesh (``mesh``), kernel calls
spread over it (``dispatch``), and the multi-process bootstrap
(``distributed``)."""
