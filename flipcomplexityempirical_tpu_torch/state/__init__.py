from .chain_state import ChainState, b_nodes_count, derive, init_state

__all__ = ["ChainState", "b_nodes_count", "derive", "init_state"]
