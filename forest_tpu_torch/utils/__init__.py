"""Parameter bridges between flax trees and torch state_dicts."""
