"""Analysis: detector statistics and the distance optimizer."""
