"""Quorum vote tally: tally_decide, masked_tally, stream_tally_decide_hist."""
