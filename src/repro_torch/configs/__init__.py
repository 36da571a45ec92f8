"""Workload configurations: the paper's own GLM workload (``glm_logreg``).
The LM zoo's configs come with the LM zoo (ROADMAP Queue 1 item 6)."""
