"""The host C++ of the MAP-graph layer (walk and peel), built at first use."""
