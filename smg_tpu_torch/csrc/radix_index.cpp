// Native radix index for cache-aware routing: the PyTorch port's own copy of
// the repository's csrc/radix_index.cpp, built by smg_tpu_torch/kv_index/native.py.
//
// C++ twin of smg_tpu_torch/kv_index/radix_tree.py (reference: crates/kv_index
// StringTree/TokenTree, SURVEY.md §2.2) exposed through a C ABI for ctypes.
// The gateway's select_worker hot path calls prefix_match on every request;
// this keeps the per-request cost flat as trees grow to millions of tokens.
//
// Structure: compressed radix tree over uint32 tokens; each node carries the
// set of workers that routed through it with an LRU tick; eviction removes
// oldest unpinned leaves until under budget.

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

struct Node {
    std::vector<uint32_t> key;
    std::unordered_map<uint32_t, Node*> children;  // first token -> child
    std::unordered_map<uint32_t, uint64_t> workers;  // worker id -> last tick
    Node* parent = nullptr;

    ~Node() {
        for (auto& kv : children) delete kv.second;
    }
};

struct Tree {
    Node root;
    size_t max_size;
    size_t size = 0;  // total key elements stored
    uint64_t clock = 0;

    explicit Tree(size_t max) : max_size(max) {}

    void insert(const uint32_t* tokens, size_t n, uint32_t worker) {
        uint64_t tick = ++clock;
        Node* node = &root;
        node->workers[worker] = tick;
        size_t i = 0;
        while (i < n) {
            auto it = node->children.find(tokens[i]);
            if (it == node->children.end()) {
                Node* child = new Node();
                child->key.assign(tokens + i, tokens + n);
                child->workers[worker] = tick;
                child->parent = node;
                node->children[tokens[i]] = child;
                size += child->key.size();
                break;
            }
            Node* child = it->second;
            size_t klen = child->key.size();
            size_t m = std::min(klen, n - i);
            size_t p = 0;
            while (p < m && child->key[p] == tokens[i + p]) p++;
            if (p < klen) {
                // split child at p
                Node* mid = new Node();
                mid->key.assign(child->key.begin(), child->key.begin() + p);
                mid->parent = node;
                mid->workers = child->workers;
                child->key.erase(child->key.begin(), child->key.begin() + p);
                child->parent = mid;
                mid->children[child->key[0]] = child;
                node->children[tokens[i]] = mid;
                child = mid;
            }
            child->workers[worker] = tick;
            node = child;
            i += p;
        }
        if (size > max_size) evict(size - max_size);
    }

    // out_workers/out_lens sized cap; returns number of (worker, len) pairs.
    size_t match(const uint32_t* tokens, size_t n, uint32_t* out_workers,
                 uint32_t* out_lens, size_t cap) const {
        std::unordered_map<uint32_t, uint32_t> best;
        const Node* node = &root;
        size_t i = 0;
        while (i < n) {
            auto it = node->children.find(tokens[i]);
            if (it == node->children.end()) break;
            const Node* child = it->second;
            size_t klen = child->key.size();
            size_t m = std::min(klen, n - i);
            size_t p = 0;
            while (p < m && child->key[p] == tokens[i + p]) p++;
            uint32_t matched = static_cast<uint32_t>(i + p);
            for (auto& w : child->workers) best[w.first] = matched;
            if (p < klen) break;
            node = child;
            i = matched;
        }
        size_t count = 0;
        for (auto& kv : best) {
            if (count >= cap) break;
            out_workers[count] = kv.first;
            out_lens[count] = kv.second;
            count++;
        }
        return count;
    }

    void remove_worker_rec(Node* node, uint32_t worker) {
        node->workers.erase(worker);
        for (auto& kv : node->children) remove_worker_rec(kv.second, worker);
    }

    void collect_leaves(Node* node, std::multimap<uint64_t, Node*>& leaves) {
        if (node->children.empty()) {
            uint64_t tick = 0;
            for (auto& w : node->workers) tick = std::max(tick, w.second);
            leaves.emplace(tick, node);
            return;
        }
        for (auto& kv : node->children) collect_leaves(kv.second, leaves);
    }

    void evict(size_t n_elements) {
        std::multimap<uint64_t, Node*> leaves;
        for (auto& kv : root.children) collect_leaves(kv.second, leaves);
        size_t freed = 0;
        for (auto it = leaves.begin(); it != leaves.end() && freed < n_elements; ++it) {
            Node* victim = it->second;
            Node* parent = victim->parent;
            if (!parent || victim->key.empty()) continue;
            parent->children.erase(victim->key[0]);
            freed += victim->key.size();
            size -= victim->key.size();
            delete victim;
            // parent may become a new (older) leaf; handled on next sweep
        }
    }
};

}  // namespace

extern "C" {

void* rt_new(size_t max_size) { return new Tree(max_size); }

void rt_free(void* t) { delete static_cast<Tree*>(t); }

void rt_insert(void* t, const uint32_t* tokens, size_t n, uint32_t worker) {
    static_cast<Tree*>(t)->insert(tokens, n, worker);
}

size_t rt_match(void* t, const uint32_t* tokens, size_t n, uint32_t* out_workers,
                uint32_t* out_lens, size_t cap) {
    return static_cast<Tree*>(t)->match(tokens, n, out_workers, out_lens, cap);
}

void rt_remove_worker(void* t, uint32_t worker) {
    Tree* tree = static_cast<Tree*>(t);
    tree->remove_worker_rec(&tree->root, worker);
}

size_t rt_size(void* t) { return static_cast<Tree*>(t)->size; }

}  // extern "C"
