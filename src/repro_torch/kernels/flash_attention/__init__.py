"""Flash attention: causal / sliding-window / GQA online softmax."""
