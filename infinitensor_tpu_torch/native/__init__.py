"""ctypes bindings of the native C++ components under native/ (the graph
scheduler; the memory planner comes with ROADMAP.md Queue 1 item 12)."""
