"""The native binned-SAH / SBVH builder (sbvh.cpp), built with g++ at first
use (sbvh_lib.py)."""
