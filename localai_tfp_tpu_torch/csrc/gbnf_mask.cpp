// GBNF pushdown recognizer + per-step token-mask engine (C ABI).
//
// Native counterpart of grammars/gbnf.py + grammars/constrain.py — the
// per-token hot path of grammar-constrained decoding (SURVEY.md §7 hard
// part #3: the host-side mask must be ready before the device step lands;
// in the reference this work happens inside llama.cpp's C++ sampler).
// Same clean-room semantics as the Python engine: "set of stacks"
// pushdown states, vocab byte-trie DFS with prefix pruning, interned
// states so the Python side holds plain ints.
//
// The port's own copy of localai_tfp_tpu/native/gbnf_mask.cpp. Built by
// grammars/native.py with g++ at first use into build/torch_kernels/.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <algorithm>
#include <memory>

namespace {

using std::string;
using std::vector;

// ---------------------------------------------------------------- symbols

enum SymKind : uint8_t { LIT = 0, CLASS = 1, REF = 2 };

struct CharRange { uint32_t lo, hi; };

struct Sym {
    SymKind kind;
    uint32_t ch = 0;        // LIT
    int32_t rule = -1;      // REF
    int32_t cls = -1;       // CLASS: index into classes
};

struct CharClass {
    vector<CharRange> ranges;
    bool negated = false;
    bool matches(uint32_t c) const {
        bool hit = false;
        for (auto &r : ranges) if (c >= r.lo && c <= r.hi) { hit = true; break; }
        return negated ? !hit : hit;
    }
};

using Alt = vector<Sym>;       // sequence of symbols
using Rule = vector<Alt>;      // alternates

// ---------------------------------------------------------------- parser

struct Parser {
    string text;
    size_t i = 0;
    std::unordered_map<string, int32_t> rule_ids;
    vector<string> rule_names;
    vector<Rule> rules;
    vector<CharClass> classes;
    int aux = 0;
    string err;

    int32_t rid(const string &name) {
        auto it = rule_ids.find(name);
        if (it != rule_ids.end()) return it->second;
        int32_t id = (int32_t)rule_names.size();
        rule_ids[name] = id;
        rule_names.push_back(name);
        rules.emplace_back();
        return id;
    }

    void ws(bool newlines = true) {
        while (i < text.size()) {
            char c = text[i];
            if (c == '#') { while (i < text.size() && text[i] != '\n') i++; }
            else if (c == ' ' || c == '\t' || c == '\r' ||
                     (newlines && c == '\n')) i++;
            else break;
        }
    }

    char peek() { return i < text.size() ? text[i] : '\0'; }

    string name() {
        size_t j = i;
        while (j < text.size() &&
               (isalnum((unsigned char)text[j]) || text[j] == '-' ||
                text[j] == '_')) j++;
        if (j == i) { err = "expected name"; return ""; }
        string n = text.substr(i, j - i);
        i = j;
        return n;
    }

    // decode one possibly-escaped char as a unicode code point; the input
    // text is UTF-8, so non-escape bytes must be UTF-8-decoded too
    uint32_t escaped_char(bool &ok) {
        ok = true;
        unsigned char c = text[i];
        if (c != '\\') return utf8_next();
        i++;  // backslash
        char e = text[i++];
        switch (e) {
            case 'n': return '\n';
            case 't': return '\t';
            case 'r': return '\r';
            case '"': return '"';
            case '\\': return '\\';
            case '/': return '/';
            case '\'': return '\'';
            case '[': return '[';
            case ']': return ']';
            case 'x': { uint32_t v = hex(2, ok); return v; }
            case 'u': { uint32_t v = hex(4, ok); return v; }
            case 'U': { uint32_t v = hex(8, ok); return v; }
        }
        ok = false;
        err = "bad escape";
        return 0;
    }

    uint32_t hex(int n, bool &ok) {
        uint32_t v = 0;
        for (int k = 0; k < n; k++) {
            char c = text[i++];
            v <<= 4;
            if (c >= '0' && c <= '9') v |= c - '0';
            else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
            else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
            else { ok = false; err = "bad hex"; return 0; }
        }
        return v;
    }

    uint32_t utf8_next() {
        unsigned char c = text[i++];
        if (c < 0x80) return c;
        int extra = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : 1;
        uint32_t v = c & (0x3F >> extra);
        for (int k = 0; k < extra && i < text.size(); k++)
            v = (v << 6) | (text[i++] & 0x3F);
        return v;
    }

    string aux_name(const string &base) {
        return base + "-aux" + std::to_string(++aux);
    }

    bool parse() {
        ws();
        while (i < text.size() && err.empty()) {
            string n = name();
            if (!err.empty()) return false;
            ws();
            if (text.compare(i, 3, "::=") != 0) {
                err = "expected '::=' after rule '" + n + "'";
                return false;
            }
            i += 3;
            Rule alts;
            if (!alternates(n, alts)) return false;
            int32_t id = rid(n);
            for (auto &a : alts) rules[id].push_back(std::move(a));
            ws();
        }
        return err.empty();
    }

    bool alternates(const string &rulename, Rule &out) {
        Alt seq;
        if (!sequence(rulename, seq)) return false;
        out.push_back(std::move(seq));
        ws(false);
        while (peek() == '|') {
            i++;
            Alt s;
            if (!sequence(rulename, s)) return false;
            out.push_back(std::move(s));
            ws(false);
        }
        return true;
    }

    bool sequence(const string &rulename, Alt &seq) {
        for (;;) {
            ws(false);
            char c = peek();
            if (c == '\0' || c == '|' || c == ')' || c == '\n') break;
            Sym s;
            if (!symbol(rulename, s)) return false;
            ws(false);
            c = peek();
            if (c == '*' || c == '+' || c == '?' || c == '{') {
                if (!apply_repeat(rulename, s, c)) return false;
            }
            seq.push_back(s);
        }
        return true;
    }

    bool symbol(const string &rulename, Sym &out) {
        char c = peek();
        bool ok = true;
        if (c == '"') {
            i++;
            vector<uint32_t> chars;
            while (peek() != '"') {
                if (i >= text.size()) { err = "unterminated string"; return false; }
                chars.push_back(escaped_char(ok));
                if (!ok) return false;
            }
            i++;
            if (chars.size() == 1) {
                out = Sym{LIT, chars[0], -1, -1};
                return true;
            }
            string n = aux_name(rulename);
            int32_t id = rid(n);
            Alt alt;
            for (uint32_t ch : chars) alt.push_back(Sym{LIT, ch, -1, -1});
            rules[id].push_back(std::move(alt));
            out = Sym{REF, 0, id, -1};
            return true;
        }
        if (c == '[') {
            i++;
            CharClass cls;
            if (peek() == '^') { cls.negated = true; i++; }
            while (peek() != ']') {
                if (i >= text.size()) { err = "unterminated class"; return false; }
                uint32_t lo = escaped_char(ok);
                if (!ok) return false;
                uint32_t hi = lo;
                if (peek() == '-' && i + 1 < text.size() && text[i + 1] != ']') {
                    i++;
                    hi = escaped_char(ok);
                    if (!ok) return false;
                }
                cls.ranges.push_back({lo, hi});
            }
            i++;
            classes.push_back(std::move(cls));
            out = Sym{CLASS, 0, -1, (int32_t)classes.size() - 1};
            return true;
        }
        if (c == '(') {
            i++;
            string n = aux_name(rulename);
            int32_t id = rid(n);
            Rule alts;
            if (!alternates(n, alts)) return false;
            ws();
            if (peek() != ')') { err = "expected ')'"; return false; }
            i++;
            rules[id] = std::move(alts);
            out = Sym{REF, 0, id, -1};
            return true;
        }
        if (c == '.') {
            i++;
            classes.push_back(CharClass{{{0, 0x10FFFF}}, false});
            out = Sym{CLASS, 0, -1, (int32_t)classes.size() - 1};
            return true;
        }
        string n = name();
        if (!err.empty()) return false;
        out = Sym{REF, 0, rid(n), -1};
        return true;
    }

    bool apply_repeat(const string &rulename, Sym &sym, char op) {
        i++;
        if (op == '{') {
            size_t j = text.find('}', i);
            if (j == string::npos) { err = "unterminated {}"; return false; }
            string body = text.substr(i, j - i);
            i = j + 1;
            int lo = 0, hi = -1;
            auto comma = body.find(',');
            if (comma != string::npos) {
                string ls = body.substr(0, comma), hs = body.substr(comma + 1);
                lo = ls.empty() ? 0 : atoi(ls.c_str());
                hi = hs.find_first_not_of(" \t") == string::npos ? -1
                     : atoi(hs.c_str());
            } else {
                lo = hi = atoi(body.c_str());
            }
            return bounded(rulename, sym, lo, hi);
        }
        string n = aux_name(rulename);
        int32_t id = rid(n);
        if (op == '?') {
            rules[id] = {{sym}, {}};
        } else if (op == '*') {
            rules[id] = {{sym, Sym{REF, 0, id, -1}}, {}};
        } else {  // '+'
            string sn = aux_name(rulename);
            int32_t sid = rid(sn);
            rules[sid] = {{sym, Sym{REF, 0, sid, -1}}, {}};
            rules[id] = {{sym, Sym{REF, 0, sid, -1}}};
        }
        sym = Sym{REF, 0, id, -1};
        return true;
    }

    bool bounded(const string &rulename, Sym &sym, int lo, int hi) {
        string n = aux_name(rulename);
        int32_t id = rid(n);
        if (hi < 0) {
            string sn = aux_name(rulename);
            int32_t sid = rid(sn);
            rules[sid] = {{sym, Sym{REF, 0, sid, -1}}, {}};
            Alt alt(lo, sym);
            alt.push_back(Sym{REF, 0, sid, -1});
            rules[id] = {std::move(alt)};
        } else {
            for (int nrep = lo; nrep <= hi; nrep++)
                rules[id].push_back(Alt(nrep, sym));
            if (rules[id].empty()) rules[id].push_back({});
        }
        sym = Sym{REF, 0, id, -1};
        return true;
    }
};

// ---------------------------------------------------------- trie + engine

struct TrieNode {
    std::unordered_map<uint32_t, int32_t> children;  // char -> node idx
    vector<int32_t> token_ids;
};

// a stack is a vector of symbols still to match (front = top); stacks and
// states (sorted sets of stack ids) are interned so callers hold ints
struct Engine {
    vector<Rule> rules;
    vector<CharClass> classes;
    int32_t root = -1;

    vector<vector<Sym>> stacks;             // id -> stack
    std::unordered_map<string, int32_t> stack_ids;  // serialized -> id
    vector<vector<int32_t>> states;         // id -> sorted stack ids
    std::unordered_map<string, int32_t> state_ids;
    std::unordered_map<uint64_t, int32_t> accept_cache;  // (state, ch)

    vector<TrieNode> trie;
    vector<vector<uint32_t>> token_chars;   // token id -> code points
    int vocab_size = 0;
    vector<int32_t> eos_ids;

    string err;

    int32_t intern_stack(const vector<Sym> &st) {
        string key;
        key.reserve(st.size() * 9);
        for (auto &s : st) {
            key.append((const char *)&s.kind, 1);
            key.append((const char *)&s.ch, 4);
            key.append((const char *)&s.rule, 4);
            key.append((const char *)&s.cls, 4);
        }
        auto it = stack_ids.find(key);
        if (it != stack_ids.end()) return it->second;
        int32_t id = (int32_t)stacks.size();
        stacks.push_back(st);
        stack_ids[key] = id;
        return id;
    }

    int32_t intern_state(vector<int32_t> ids) {
        std::sort(ids.begin(), ids.end());
        ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
        string key((const char *)ids.data(), ids.size() * 4);
        auto it = state_ids.find(key);
        if (it != state_ids.end()) return it->second;
        int32_t id = (int32_t)states.size();
        states.push_back(std::move(ids));
        state_ids[key] = id;
        return id;
    }

    // expand leading REFs until top is terminal or stack empty
    void expand(vector<Sym> stack, vector<int32_t> &out,
                std::unordered_set<string> &seen) {
        string key;
        key.reserve(stack.size() * 9);
        for (auto &s : stack) {
            key.append((const char *)&s.kind, 1);
            key.append((const char *)&s.ch, 4);
            key.append((const char *)&s.rule, 4);
            key.append((const char *)&s.cls, 4);
        }
        if (!seen.insert(key).second) return;
        if (stack.empty() || stack.front().kind != REF) {
            out.push_back(intern_stack(stack));
            return;
        }
        Sym ref = stack.front();
        vector<Sym> rest(stack.begin() + 1, stack.end());
        for (auto &alt : rules[ref.rule]) {
            vector<Sym> ns(alt);
            ns.insert(ns.end(), rest.begin(), rest.end());
            expand(std::move(ns), out, seen);
        }
    }

    int32_t initial_state() {
        vector<int32_t> out;
        std::unordered_set<string> seen;
        for (auto &alt : rules[root]) expand(alt, out, seen);
        return intern_state(std::move(out));
    }

    bool sym_matches(const Sym &s, uint32_t ch) const {
        if (s.kind == LIT) return s.ch == ch;
        if (s.kind == CLASS) return classes[s.cls].matches(ch);
        return false;
    }

    int32_t accept_char(int32_t state, uint32_t ch) {
        uint64_t key = ((uint64_t)state << 24) ^ ch;
        auto it = accept_cache.find(key);
        if (it != accept_cache.end()) return it->second;
        vector<int32_t> out;
        std::unordered_set<string> seen;
        for (int32_t sid : states[state]) {
            const auto &stack = stacks[sid];
            if (stack.empty()) continue;
            if (sym_matches(stack.front(), ch)) {
                vector<Sym> rest(stack.begin() + 1, stack.end());
                expand(std::move(rest), out, seen);
            }
        }
        int32_t res = intern_state(std::move(out));
        accept_cache[key] = res;
        return res;
    }

    bool is_dead(int32_t state) const { return states[state].empty(); }

    bool can_end(int32_t state) const {
        for (int32_t sid : states[state])
            if (stacks[sid].empty()) return true;
        return false;
    }

    int32_t advance_token(int32_t state, int32_t tok) {
        if (tok < 0 || tok >= (int)token_chars.size()) return state;
        for (uint32_t ch : token_chars[tok]) {
            if (is_dead(state)) return state;
            state = accept_char(state, ch);
        }
        return state;
    }

    // ------------------------------------------------------------- vocab

    void set_vocab(int n) {
        vocab_size = n;
        token_chars.assign(n, {});
        trie.clear();
        trie.emplace_back();
    }

    void add_token(int id, const char *utf8, int len) {
        if (id < 0 || id >= vocab_size || len <= 0) return;
        vector<uint32_t> chars;
        size_t i = 0;
        string s(utf8, len);
        while (i < s.size()) {
            unsigned char c = s[i++];
            uint32_t v;
            if (c < 0x80) v = c;
            else {
                int extra = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : 1;
                v = c & (0x3F >> extra);
                for (int k = 0; k < extra && i < s.size(); k++)
                    v = (v << 6) | (s[i++] & 0x3F);
            }
            chars.push_back(v);
        }
        token_chars[id] = chars;
        int32_t node = 0;
        for (uint32_t ch : chars) {
            auto it = trie[node].children.find(ch);
            if (it == trie[node].children.end()) {
                int32_t nxt = (int32_t)trie.size();
                trie[node].children[ch] = nxt;
                trie.emplace_back();
                node = nxt;
            } else node = it->second;
        }
        trie[node].token_ids.push_back(id);
    }

    void mask(int32_t state, uint8_t *out) {
        memset(out, 0, vocab_size);
        // DFS over the vocab trie, pruning rejected prefixes
        vector<std::pair<int32_t, int32_t>> stack = {{0, state}};
        while (!stack.empty()) {
            auto [node, st] = stack.back();
            stack.pop_back();
            for (int32_t tid : trie[node].token_ids) out[tid] = 1;
            for (auto &[ch, child] : trie[node].children) {
                int32_t nst = accept_char(st, ch);
                if (!is_dead(nst)) stack.push_back({child, nst});
            }
        }
        if (can_end(state))
            for (int32_t e : eos_ids)
                if (e >= 0 && e < vocab_size) out[e] = 1;
    }
};

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

void *gbnf_new(const char *grammar_text, char *errbuf, int errlen) {
    Parser p;
    p.text = grammar_text;
    // pre-register nothing; parse builds rules
    if (!p.parse()) {
        if (errbuf && errlen > 0) {
            strncpy(errbuf, p.err.c_str(), errlen - 1);
            errbuf[errlen - 1] = 0;
        }
        return nullptr;
    }
    auto it = p.rule_ids.find("root");
    if (it == p.rule_ids.end()) {
        if (errbuf && errlen > 0)
            strncpy(errbuf, "grammar has no 'root' rule", errlen - 1);
        return nullptr;
    }
    // a rule that was referenced but never defined has zero alternates
    // (rid() auto-creates it empty); the Python engine raises KeyError for
    // this — surface the same error instead of a silently-dead grammar
    for (size_t r = 0; r < p.rules.size(); r++) {
        if (p.rules[r].empty()) {
            if (errbuf && errlen > 0) {
                std::string msg = "undefined rule '" + p.rule_names[r] + "'";
                strncpy(errbuf, msg.c_str(), errlen - 1);
                errbuf[errlen - 1] = 0;
            }
            return nullptr;
        }
    }
    auto *e = new Engine();
    e->rules = std::move(p.rules);
    e->classes = std::move(p.classes);
    e->root = it->second;
    return e;
}

void gbnf_free(void *h) { delete (Engine *)h; }

void gbnf_set_vocab(void *h, int vocab_size) {
    ((Engine *)h)->set_vocab(vocab_size);
}

void gbnf_add_token(void *h, int id, const char *utf8, int len) {
    ((Engine *)h)->add_token(id, utf8, len);
}

void gbnf_add_eos(void *h, int id) {
    ((Engine *)h)->eos_ids.push_back(id);
}

int gbnf_initial(void *h) { return ((Engine *)h)->initial_state(); }

int gbnf_advance(void *h, int state, int token) {
    return ((Engine *)h)->advance_token(state, token);
}

int gbnf_accept_text(void *h, int state, const char *utf8, int len) {
    auto *e = (Engine *)h;
    string s(utf8, len);
    size_t i = 0;
    while (i < s.size() && !e->is_dead(state)) {
        unsigned char c = s[i++];
        uint32_t v;
        if (c < 0x80) v = c;
        else {
            int extra = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : 1;
            v = c & (0x3F >> extra);
            for (int k = 0; k < extra && i < s.size(); k++)
                v = (v << 6) | (s[i++] & 0x3F);
        }
        state = e->accept_char(state, v);
    }
    return state;
}

int gbnf_can_end(void *h, int state) {
    return ((Engine *)h)->can_end(state) ? 1 : 0;
}

int gbnf_is_dead(void *h, int state) {
    return ((Engine *)h)->is_dead(state) ? 1 : 0;
}

void gbnf_mask(void *h, int state, uint8_t *out) {
    ((Engine *)h)->mask(state, out);
}

}  // extern "C"
