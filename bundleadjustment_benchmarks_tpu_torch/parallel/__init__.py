"""Distributed bundle adjustment over ``torch.distributed``: ``sharded``
(points and observations sharded, cameras replicated) and ``multihost``
(process groups, local ranks)."""
