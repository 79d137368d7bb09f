// Host-side block-diagonal padded-batch assembler of kagnn_tpu_torch.
//
// A copy of the JAX package's native/batcher.cpp `assemble_batch` and
// `degree_onehot`. `assemble_batch`, in one
// pass over dataset arrays concatenated once, the block-diagonal edge
// relabeling, the counting sort by receiver (stable within a receiver), the
// counting sort by sender, the masks, segment ids and feature gathering.
// The Python wrapper (kagnn_tpu_torch/data/native.py) derives the rest of a
// GraphBatch from these arrays as graphs/batch.py does for every batch.
// Built by g++ at first use and called through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Assemble one padded batch.
//
// Dataset layout (built once per dataset by the Python wrapper):
//   senders/receivers: concatenated per-graph edge lists (LOCAL node ids)
//   edge_offsets[g] .. edge_offsets[g+1]: graph g's edge range
//   node_counts[g]: graph g's node count
//   node_feat: concatenated (total_nodes, feat_dim) float32 node features
//   node_feat_offsets[g]: row offset of graph g's features
//
// Selection: sel[0..n_sel) are dataset graph indices for this batch.
//
// Outputs (caller-allocated, padded sizes):
//   out_snd/out_rcv (n_edge_pad), out_edge_mask (n_edge_pad)
//   out_node_mask (n_node_pad), out_node_graph (n_node_pad)
//   out_feat (n_node_pad * feat_dim) — zero-filled padding
//   out_counts[0]=n_node, [1]=n_edge, [2]=n_graph
//
// Returns 0 on success, -1 if the selection exceeds the padded sizes.
int assemble_batch(
    const int32_t* senders, const int32_t* receivers,
    const int64_t* edge_offsets, const int64_t* node_counts,
    const float* node_feat, const int64_t* node_feat_offsets,
    int64_t feat_dim,
    const int64_t* sel, int64_t n_sel,
    int64_t n_node_pad, int64_t n_edge_pad, int64_t n_graph_pad,
    int32_t* out_snd, int32_t* out_rcv, uint8_t* out_edge_mask,
    uint8_t* out_node_mask, int32_t* out_node_graph, float* out_feat,
    int32_t* out_perm, int32_t* out_snd_sorted,
    int64_t* out_counts) {
  if (n_sel + 1 > n_graph_pad) return -1;

  // pass 1: totals + node offsets within the batch
  std::vector<int64_t> node_base(n_sel + 1, 0);
  int64_t n_edge = 0;
  for (int64_t i = 0; i < n_sel; ++i) {
    const int64_t g = sel[i];
    node_base[i + 1] = node_base[i] + node_counts[g];
    n_edge += edge_offsets[g + 1] - edge_offsets[g];
  }
  const int64_t n_node = node_base[n_sel];
  if (n_node >= n_node_pad || n_edge > n_edge_pad) return -1;

  // counting sort by (global) receiver: histogram
  std::vector<int64_t> hist(n_node + 1, 0);
  for (int64_t i = 0; i < n_sel; ++i) {
    const int64_t g = sel[i];
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      hist[node_base[i] + receivers[e]]++;
    }
  }
  // exclusive prefix sum
  int64_t run = 0;
  for (int64_t v = 0; v <= n_node; ++v) {
    const int64_t c = hist[v];
    hist[v] = run;
    run += c;
  }
  // scatter edges into sorted position (stable within receiver)
  for (int64_t i = 0; i < n_sel; ++i) {
    const int64_t g = sel[i];
    const int64_t base = node_base[i];
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      const int64_t r = base + receivers[e];
      const int64_t pos = hist[r]++;
      out_snd[pos] = static_cast<int32_t>(base + senders[e]);
      out_rcv[pos] = static_cast<int32_t>(r);
      out_edge_mask[pos] = 1;
    }
  }
  // edge padding -> last padded node
  for (int64_t e = n_edge; e < n_edge_pad; ++e) {
    out_snd[e] = static_cast<int32_t>(n_node_pad - 1);
    out_rcv[e] = static_cast<int32_t>(n_node_pad - 1);
    out_edge_mask[e] = 0;
  }

  // sender-sort metadata: counting sort of the assembled edges by sender
  // (perm s.t. out_snd[perm] ascending; padded edges land at the end since
  // they point at the last padded node)
  {
    std::vector<int64_t> shist(n_node_pad + 1, 0);
    for (int64_t e = 0; e < n_edge_pad; ++e) shist[out_snd[e]]++;
    int64_t srun = 0;
    for (int64_t v = 0; v <= n_node_pad; ++v) {
      const int64_t c = shist[v];
      shist[v] = srun;
      srun += c;
    }
    for (int64_t e = 0; e < n_edge_pad; ++e) {
      const int64_t pos = shist[out_snd[e]]++;
      out_perm[pos] = static_cast<int32_t>(e);
      out_snd_sorted[pos] = out_snd[e];
    }
  }

  // node masks / segment ids / features
  for (int64_t i = 0; i < n_sel; ++i) {
    const int64_t g = sel[i];
    const int64_t cnt = node_counts[g];
    for (int64_t v = 0; v < cnt; ++v) {
      out_node_mask[node_base[i] + v] = 1;
      out_node_graph[node_base[i] + v] = static_cast<int32_t>(i);
    }
    std::memcpy(out_feat + node_base[i] * feat_dim,
                node_feat + node_feat_offsets[g] * feat_dim,
                sizeof(float) * cnt * feat_dim);
  }
  for (int64_t v = n_node; v < n_node_pad; ++v) {
    out_node_mask[v] = 0;
    out_node_graph[v] = static_cast<int32_t>(n_graph_pad - 1);
  }
  std::memset(out_feat + n_node * feat_dim, 0,
              sizeof(float) * (n_node_pad - n_node) * feat_dim);

  out_counts[0] = n_node;
  out_counts[1] = n_edge;
  out_counts[2] = n_sel;
  return 0;
}

// Degree one-hot features (reference Degree transform,
// graph_classification_utils.py:31-36) computed natively for a whole
// concatenated dataset in one pass.
void degree_onehot(const int32_t* senders, const int64_t* edge_offsets,
                   const int64_t* node_counts, const int64_t* node_feat_offsets,
                   int64_t n_graphs, int64_t max_degree, float* out_feat) {
  const int64_t dim = max_degree + 1;
  for (int64_t g = 0; g < n_graphs; ++g) {
    std::vector<int32_t> deg(node_counts[g], 0);
    for (int64_t e = edge_offsets[g]; e < edge_offsets[g + 1]; ++e) {
      deg[senders[e]]++;
    }
    float* base = out_feat + node_feat_offsets[g] * dim;
    for (int64_t v = 0; v < node_counts[g]; ++v) {
      const int64_t d = deg[v] > max_degree ? max_degree : deg[v];
      base[v * dim + d] = 1.0f;
    }
  }
}

}  // extern "C"
